"""Seeded, replayable packet streams (counterpart of
``repro.data.traffic``; numpy only, a copy of the parts the flow path
uses).

Packet record (float32 row, ``COLUMNS`` order):

  ``flow_id``   integral flow key (< 2^22, exact in f32)
  ``pkt_len``   bytes on the wire
  ``ipt_s``     inter-arrival gap to this flow's previous packet (0 for
                the flow's first packet)
  ``dst_port``  destination port (bucketed small int)

``make_stream`` is deterministic in (scenario, seed, sizes) and gives the
same packets as the reference for the same arguments.
``flow_feature_stages`` builds the port's stateful prefix,
``fold_input_standardization`` folds an input standardisation into the
port's first dense layer, and ``reaction_report`` measures detection and
mitigation per attack flow from a verdict stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COLUMNS = ("flow_id", "pkt_len", "ipt_s", "dst_port")
COL_FLOW, COL_LEN, COL_IPT, COL_PORT = range(4)

SCENARIOS = ("benign", "ddos_burst", "port_scan", "elephant_mice",
             "concept_drift", "syn_flood", "udp_flood", "icmp_flood",
             "slow_scan", "coordinated_ddos")

# verdict of a packet the action table dropped (the port's
# ``flowstate.mitigation.MITIGATED``; mirrored so this module stays
# numpy only)
_MITIGATED = -1

# concept_drift: fraction of the span where phase B (the shifted attack
# signature) begins — phase A attacks live strictly before it
DRIFT_FRAC = 0.5


@dataclasses.dataclass
class PacketStream:
    """A time-ordered packet stream with per-packet ground truth."""

    scenario: str
    packets: np.ndarray        # [N, 4] f32, COLUMNS order, time-sorted
    labels: np.ndarray         # [N] int32 per-packet (= flow label)
    flow_ids: np.ndarray       # [N] int32 (packets[:, COL_FLOW] as int)
    flow_labels: dict          # flow_id -> label
    times: np.ndarray | None = None   # [N] f64 arrival timestamps

    @property
    def n_packets(self) -> int:
        return len(self.packets)

    @property
    def n_flows(self) -> int:
        return len(self.flow_labels)

    def chunks(self, size: int):
        """Replayable chunk iterator (fresh, identical sequence per call)."""
        for s in range(0, len(self.packets), size):
            yield self.packets[s:s + size]


# ------------------------------------------------------------- flow shapes


def _flow(fid, label, t0, sizes, gaps, port):
    return {"fid": int(fid), "label": int(label), "t0": float(t0),
            "sizes": sizes, "gaps": gaps, "port": int(port)}


def _benign_flows(rng, n_flows: int, span: float) -> list[dict]:
    flows = []
    for _ in range(n_flows):
        kind = rng.random()
        if kind < 0.45:       # interactive/web: smallish bimodal packets
            n = int(rng.integers(8, 60))
            sizes = np.where(rng.random(n) < 0.6,
                             rng.normal(240, 80, n),
                             rng.normal(1100, 180, n))
            gaps = rng.lognormal(np.log(0.15), 1.0, n)
            port = int(rng.choice((80, 443)))
        elif kind < 0.8:      # bulk transfer: MTU-sized, tiny gaps
            n = int(rng.integers(60, 300))
            sizes = rng.normal(1380, 60, n)
            gaps = rng.lognormal(np.log(0.01), 0.7, n)
            port = int(rng.choice((443, 8080)))
        else:                 # DHT-ish chatty mode (the confuser)
            n = int(rng.integers(20, 120))
            sizes = rng.normal(300, 90, n)
            gaps = rng.lognormal(np.log(1.0), 1.1, n)
            port = 6881
        flows.append(_flow(0, 0, rng.uniform(0, span * 0.7), sizes, gaps,
                           port))
    return flows


def _attack_flows(rng, scenario: str, span: float) -> list[dict]:
    flows = []
    if scenario == "ddos_burst":
        # volumetric burst from many (spoofed-source) flows onto one port
        burst_t = span * 0.3
        for _ in range(120):
            n = int(rng.integers(40, 160))
            sizes = rng.normal(90, 25, n)              # tiny payloads
            gaps = rng.lognormal(np.log(1.5e-3), 0.5, n)   # ~kHz per flow
            flows.append(_flow(0, 1, burst_t + rng.uniform(0, span * 0.2),
                               sizes, gaps, 80))
    elif scenario == "port_scan":
        # one scanner host: a 1-2 packet SYN-sized flow per swept port
        t = span * 0.25
        for i in range(400):
            n = int(rng.integers(1, 3))
            sizes = rng.normal(48, 4, n)
            gaps = rng.lognormal(np.log(5e-3), 0.4, n)
            flows.append(_flow(0, 1, t, sizes, gaps, 1024 + i))
            t += float(rng.uniform(2e-3, 8e-3))
    elif scenario == "elephant_mice":
        for _ in range(12):
            n = int(rng.integers(600, 1500))
            sizes = rng.normal(1430, 25, n)
            gaps = rng.lognormal(np.log(8e-4), 0.4, n)
            flows.append(_flow(0, 1, rng.uniform(0, span * 0.3), sizes,
                               gaps, 443))
    elif scenario == "concept_drift":
        drift_t = span * DRIFT_FRAC
        # phase A (< DRIFT_FRAC): the ddos_burst signature — many short
        # tiny-packet high-rate flows onto one service port.  A model
        # trained on this phase keys on the small-packet histogram mass.
        for _ in range(70):
            n = int(rng.integers(40, 120))
            sizes = rng.normal(90, 25, n)
            gaps = rng.lognormal(np.log(1.5e-3), 0.5, n)
            flows.append(_flow(0, 1,
                               rng.uniform(span * 0.05, drift_t * 0.7),
                               sizes, gaps, 80))
        # phase B (>= DRIFT_FRAC): a stealth MTU flood — per-packet shape
        # mimics benign bulk transfers (MTU sizes, similar gaps, port
        # 443); only flow VOLUME separates it (elephant lifetimes, so
        # pkt/byte counters run far past any benign bulk flow).  The
        # phase-A model sees none of its signature and misses it.
        for _ in range(30):
            n = int(rng.integers(500, 1100))
            sizes = rng.normal(1430, 40, n)
            gaps = rng.lognormal(np.log(8e-3), 0.3, n)
            flows.append(_flow(0, 1,
                               drift_t + rng.uniform(0, span * 0.25),
                               sizes, gaps, 443))
    elif scenario == "syn_flood":
        # three escalating waves of spoofed-source SYN-sized flows onto
        # one service port; each wave doubles the per-flow packet rate
        for t_frac, gap in ((0.25, 2e-3), (0.45, 1e-3), (0.65, 5e-4)):
            for _ in range(45):
                n = int(rng.integers(30, 120))
                sizes = rng.normal(60, 6, n)
                gaps = rng.lognormal(np.log(gap), 0.4, n)
                flows.append(_flow(0, 1,
                                   span * t_frac + rng.uniform(0, span * 0.08),
                                   sizes, gaps, 443))
    elif scenario == "udp_flood":
        # amplification-style UDP flood onto port 53, two rate waves
        for t_frac, gap in ((0.3, 1.5e-3), (0.55, 8e-4)):
            for _ in range(60):
                n = int(rng.integers(40, 150))
                sizes = rng.normal(512, 120, n)
                gaps = rng.lognormal(np.log(gap), 0.5, n)
                flows.append(_flow(0, 1,
                                   span * t_frac + rng.uniform(0, span * 0.1),
                                   sizes, gaps, 53))
    elif scenario == "icmp_flood":
        # ping flood: constant echo-sized packets, port-0 proxy for ICMP
        for _ in range(100):
            n = int(rng.integers(40, 160))
            sizes = rng.normal(84, 8, n)
            gaps = rng.lognormal(np.log(1e-3), 0.5, n)
            flows.append(_flow(0, 1,
                               span * 0.3 + rng.uniform(0, span * 0.25),
                               sizes, gaps, 0))
    elif scenario == "slow_scan":
        # slow-drip recon: probes every few hundred ms across the WHOLE
        # span — per-flow rate looks benign, only the 1-2-packet
        # SYN-sized shape gives it away
        t = span * 0.05
        for _ in range(260):
            n = int(rng.integers(1, 3))
            sizes = rng.normal(48, 4, n)
            gaps = rng.lognormal(np.log(5e-3), 0.4, n)
            flows.append(_flow(0, 1, t, sizes, gaps,
                               1024 + int(rng.integers(0, 4096))))
            t += float(rng.uniform(0.25, 0.45))
    elif scenario == "coordinated_ddos":
        # multi-source DDoS: four source groups, staggered onsets and
        # per-group rates, converging on one service port
        for g, gap in enumerate((2.5e-3, 1.8e-3, 1.2e-3, 8e-4)):
            t0 = span * (0.3 + 0.08 * g)
            for _ in range(35):
                n = int(rng.integers(30, 120))
                sizes = rng.normal(110, 30, n)
                gaps = rng.lognormal(np.log(gap), 0.4, n)
                flows.append(_flow(0, 1, t0 + rng.uniform(0, span * 0.06),
                                   sizes, gaps, 80))
    else:
        raise KeyError(scenario)
    return flows


def make_stream(scenario: str, *, n_packets: int = 30_000,
                n_benign_flows: int = 220, span_s: float = 120.0,
                seed: int = 0) -> PacketStream:
    """Synthesize one scenario as a time-ordered stream of ~``n_packets``
    packets (trimmed exactly after the merge).  Deterministic in all
    arguments; attack scenarios keep the benign baseline running
    throughout, so detection is measured against live background traffic."""
    if scenario not in SCENARIOS:
        raise KeyError(f"scenario must be one of {SCENARIOS}")
    rng = np.random.default_rng(seed)
    # scale the baseline with the packet budget so trimming to n_packets
    # never cuts the stream before the attack phase begins
    n_benign = max(8, int(round(n_benign_flows
                                * min(1.0, n_packets / 30_000))))
    flows = _benign_flows(rng, n_benign, span_s)
    if scenario != "benign":
        flows += _attack_flows(rng, scenario, span_s)

    # unique non-negative flow ids, exact in f32
    ids = rng.permutation(1 << 20)[:len(flows)]
    for f, fid in zip(flows, ids):
        f["fid"] = int(fid)

    fid_col, t_col, len_col, port_col, lab_col = [], [], [], [], []
    for f in flows:
        n = len(f["sizes"])
        gaps = np.clip(np.asarray(f["gaps"], np.float64), 1e-5, 600.0)
        t = f["t0"] + np.cumsum(gaps) - gaps[0]    # first packet at t0
        fid_col.append(np.full(n, f["fid"], np.int64))
        t_col.append(t)
        len_col.append(np.clip(f["sizes"], 40, 1500))
        port_col.append(np.full(n, f["port"], np.int64))
        lab_col.append(np.full(n, f["label"], np.int64))
    fid = np.concatenate(fid_col)
    t = np.concatenate(t_col)
    plen = np.concatenate(len_col)
    port = np.concatenate(port_col)
    lab = np.concatenate(lab_col)

    # global arrival order; stable so same-timestamp packets keep flow order
    order = np.argsort(t, kind="stable")
    fid, t, plen, port, lab = (a[order] for a in (fid, t, plen, port, lab))

    # per-flow inter-arrival gaps: diff within each flow's packet sequence
    by_flow = np.lexsort((t, fid))
    tt, ff = t[by_flow], fid[by_flow]
    d = np.diff(tt, prepend=tt[:1])
    same = np.diff(ff, prepend=ff[:1] - 1) == 0
    ipt = np.zeros_like(t)
    ipt[by_flow] = np.where(same, d, 0.0)

    n = min(n_packets, len(fid))
    packets = np.stack(
        [fid[:n], plen[:n], ipt[:n], port[:n]], axis=1
    ).astype(np.float32)
    flow_labels = {int(f["fid"]): int(f["label"]) for f in flows}
    return PacketStream(scenario, packets, lab[:n].astype(np.int32),
                        fid[:n].astype(np.int32), flow_labels,
                        times=t[:n].astype(np.float64))


# ------------------------------------------------- stateful feature stages


def flow_feature_stages(*, n_slots: int = 2048, pl_bins: int = 16,
                        ipt_bins: int = 8, ewma_alpha: float = 0.125):
    """The canonical stateful prefix for ``COLUMNS`` packet streams.

    -> ((FlowKey, RegisterUpdate, WindowStats), feature_names): per-flow
    packet/byte counters, EWMAs of packet length and inter-arrival time,
    and packet-length ++ IPT histograms normalised by the packet count."""
    from repro_torch.core import stageir
    from repro_torch.flowstate.registers import FlowStateSpec

    pl_edges = np.linspace(0.0, 1500.0, pl_bins + 1)[1:-1]
    ipt_edges = np.geomspace(1e-4, 120.0, ipt_bins + 1)[1:-1]
    spec = FlowStateSpec(
        n_slots=n_slots, n_counters=2, n_ewma=2,
        hist_sizes=(pl_bins, ipt_bins), ewma_alpha=ewma_alpha,
    )
    fk = stageir.FlowKey(key_cols=(COL_FLOW,), n_slots=n_slots)
    ru = stageir.RegisterUpdate(
        spec,
        counter_cols=(COL_LEN,),             # counter 1: byte count
        ewma_cols=(COL_LEN, COL_IPT),
        hist_cols=(COL_LEN, COL_IPT),
        hist_edges=(pl_edges, ipt_edges),
    )
    ws = stageir.WindowStats(spec, mode="all")
    names = (["pkt_count", "byte_count", "ewma_len", "ewma_ipt"]
             + [f"pl_bin_{i}" for i in range(pl_bins)]
             + [f"ipt_bin_{i}" for i in range(ipt_bins)])
    return (fk, ru, ws), names


def fold_input_standardization(stages, mu: np.ndarray, sd: np.ndarray):
    """Fold ``(x - mu) / sd`` into the first dense layer of a classifier
    suffix so the served pipeline takes raw register rows:
    ``x @ (W / sd[:, None]) + (b - (mu / sd) @ W)``.  Returns a rewritten
    copy of the stages."""
    from repro_torch.core.stageir import Dense, FusedClassify, FusedMLP

    out = []
    done = False
    for s in stages:
        if not done and isinstance(s, (FusedMLP, FusedClassify)):
            w0 = np.asarray(s.weights[0], np.float32)
            b0 = np.asarray(s.biases[0], np.float32)
            weights = [w0 / sd[:, None]] + [np.asarray(w)
                                            for w in s.weights[1:]]
            biases = [b0 - (mu / sd) @ w0] + [np.asarray(b)
                                              for b in s.biases[1:]]
            out.append(type(s)(weights, biases))
            done = True
        elif not done and isinstance(s, Dense):
            w0 = np.asarray(s.w, np.float32)
            b0 = np.asarray(s.b, np.float32)
            out.append(Dense(w0 / sd[:, None], b0 - (mu / sd) @ w0, s.act))
            done = True
        else:
            out.append(s)
    if not done:
        raise ValueError("no dense layer to fold the standardization into")
    return out


def reaction_report(stream: PacketStream, verdicts: np.ndarray) -> dict:
    """Per attack flow: packets until the first positive verdict (1-based,
    the paper's packets-until-detection), and the benign false-positive
    flow rate.  When the verdicts carry ``_MITIGATED`` (-1) from a
    ``Mitigate`` stage it also measures what the data plane enforced:
    ``mitigation_lag_*`` is the packet count from a flow's first detection
    to its first drop, and ``leaked_pkts_total`` counts attack packets
    that pass after their flow's first drop."""
    verdicts = np.asarray(verdicts)
    react, undetected, fp_flows, benign_flows = [], 0, 0, 0
    lags, mitigated, leaked, benign_mitigated = [], 0, 0, 0
    for fid, label in stream.flow_labels.items():
        mask = stream.flow_ids == fid
        if not mask.any():
            continue
        v = verdicts[mask]
        hits = np.nonzero(v == 1)[0]
        mits = np.nonzero(v == _MITIGATED)[0]
        if label == 1:
            if len(hits):
                react.append(int(hits[0]) + 1)
            else:
                undetected += 1
            if len(mits):
                mitigated += 1
                first_mit = int(mits[0])
                if len(hits):
                    lags.append(first_mit - int(hits[0]))
                leaked += int(np.sum(v[first_mit:] != _MITIGATED))
        else:
            benign_flows += 1
            fp_flows += bool(len(hits))
            benign_mitigated += bool(len(mits))
    react_arr = np.asarray(react, np.float64)
    lag_arr = np.asarray(lags, np.float64)
    n_attack = len(react) + undetected
    # 0.0 (not NaN) when nothing was detected or no attack flow exists
    return {
        "attack_flows": n_attack,
        "detected_flows": len(react),
        "detection_rate": (len(react) / n_attack) if n_attack else 0.0,
        "reaction_pkts_median": (float(np.median(react_arr))
                                 if len(react) else 0.0),
        "reaction_pkts_p95": (float(np.percentile(react_arr, 95))
                              if len(react) else 0.0),
        "benign_fp_flow_rate": (fp_flows / benign_flows) if benign_flows
        else 0.0,
        "mitigated_flows": mitigated,
        "mitigation_lag_median": (float(np.median(lag_arr))
                                  if len(lags) else 0.0),
        "mitigation_lag_p95": (float(np.percentile(lag_arr, 95))
                               if len(lags) else 0.0),
        "leaked_pkts_total": leaked,
        "benign_mitigated_flow_rate": (benign_mitigated / benign_flows)
        if benign_flows else 0.0,
    }
