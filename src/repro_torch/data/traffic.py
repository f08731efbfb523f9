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
same packets as the reference for the same arguments; ``PacketStream.slice``
cuts a packet-index window out of one.
``flow_feature_stages`` builds the port's stateful prefix,
``stream_feature_dataset`` replays a stream through it on the card (K2)
into a standardised training set, ``fold_input_standardization`` folds
that standardisation into the port's first dense layer, and
``reaction_report`` measures detection and mitigation per attack flow
from a verdict stream.

Topology-aware serving (``switch_of_flow``, ``switch_streams``,
``compose_streams``) pins every flow to an ingress switch and slices one
stream into per-switch arrival-ordered views, and composes them back;
``windowed_flow_stats`` collects per-window per-flow aggregates and
``auto_label`` derives heuristic labels from them.  These are numpy
copies of the reference's arithmetic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COLUMNS = ("flow_id", "pkt_len", "ipt_s", "dst_port")
COL_FLOW, COL_LEN, COL_IPT, COL_PORT = range(4)

SCENARIOS = ("benign", "ddos_burst", "port_scan", "elephant_mice",
             "concept_drift", "syn_flood", "udp_flood", "icmp_flood",
             "slow_scan", "coordinated_ddos")

# scenarios whose attack flows a rate-style detector should catch (used by
# the replay harness to pick what the closed loop is exercised on)
FLOOD_SCENARIOS = ("ddos_burst", "syn_flood", "udp_flood", "icmp_flood",
                   "coordinated_ddos")

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

    def slice(self, start: int, stop: int | None = None) -> "PacketStream":
        """A contiguous packet-index window as its own stream (flow_labels
        keep only flows that appear — reaction metrics stay per-segment)."""
        sl = slice(start, stop)
        fids = self.flow_ids[sl]
        present = set(int(f) for f in np.unique(fids))
        return PacketStream(
            self.scenario, self.packets[sl], self.labels[sl], fids,
            {f: l for f, l in self.flow_labels.items() if f in present},
            None if self.times is None else self.times[sl],
        )


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


def stream_feature_dataset(stream: PacketStream, stages, names, *,
                           sample_every: int = 2, test_frac: float = 0.3,
                           chunk: int = 1024, seed: int = 0,
                           device="cuda"):
    """Replay a stream through the register file and collect per-packet
    (WindowStats features, flow label) pairs as a standardised
    ``netdata.Dataset`` -> (dataset, mu, sd).

    The replay is the port's own serving path on ``device``:
    ``StatefulPipeline(stages, backend="cuda", fuse=False)`` behind a
    ``PacketServeEngine``, so on the card the register update is K2
    (Exact: the same feature rows, bit for bit, as the reference's
    ``interpret`` replay) and the WindowStats readout the split path's
    own.  ``mu``/``sd`` are the training split's feature moments; fold
    them into the classifier's first layer
    (``fold_input_standardization``) so the served pipeline takes raw
    register rows."""
    from repro_torch.data.netdata import Dataset
    from repro_torch.flowstate.pipeline import StatefulPipeline
    from repro_torch.serve.packet_engine import PacketServeEngine

    sp = StatefulPipeline(list(stages), backend="cuda", fuse=False,
                          device=device)
    eng = PacketServeEngine(sp, feature_dim=len(COLUMNS), max_batch=chunk,
                            device=device)
    feats = []
    for c in stream.chunks(chunk):
        eng.submit(c)
        feats.append(eng.flush())
    X = (np.concatenate(feats, 0).astype(np.float32) if feats
         else np.zeros((0, len(list(names))), np.float32))
    y = stream.labels.astype(np.int32)
    X, y = X[::sample_every], y[::sample_every]

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(X))
    # degenerate guards: a stream shorter than one window still yields a
    # usable dataset — both splits non-empty whenever >= 2 rows exist, a
    # single row serves as its own train AND test, zero rows standardize
    # with identity moments (never NaN)
    if len(X) >= 2:
        n_test = min(max(1, int(len(X) * test_frac)), len(X) - 1)
        te, tr = perm[:n_test], perm[n_test:]
    else:
        te = tr = perm
    if len(tr):
        mu = X[tr].mean(0)
        sd = X[tr].std(0) + 1e-6
    else:
        mu = np.zeros(X.shape[1], np.float32)
        sd = np.ones(X.shape[1], np.float32)
    ds = Dataset(
        name=f"flowstats-{stream.scenario}",
        train_x=((X[tr] - mu) / sd).astype(np.float32), train_y=y[tr],
        test_x=((X[te] - mu) / sd).astype(np.float32), test_y=y[te],
        feature_names=list(names), num_classes=2,
    )
    return ds, mu.astype(np.float32), sd.astype(np.float32)


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


# -------------------------------------------------- topology-aware streams


def switch_of_flow(flow_ids: np.ndarray, n_switches: int) -> np.ndarray:
    """Deterministic flow -> ingress-switch pinning (Knuth multiplicative
    mix, so consecutive flow ids spread across switches)."""
    h = np.asarray(flow_ids, np.int64).astype(np.uint32) * np.uint32(2654435761)
    h ^= h >> np.uint32(16)
    return (h % np.uint32(n_switches)).astype(np.int64)


def switch_streams(stream: PacketStream, n_switches: int) -> list:
    """Slice one stream into ``n_switches`` per-switch views: every flow is
    pinned whole to one ingress switch, so per-flow inter-arrival gaps in
    the packet records stay valid and each view is itself arrival-ordered.
    A multi-switch deployment serves each view through its own engine."""
    if n_switches < 1:
        raise ValueError("n_switches must be >= 1")
    sw = switch_of_flow(stream.flow_ids, n_switches)
    out = []
    for s in range(n_switches):
        mask = sw == s
        fids = stream.flow_ids[mask]
        present = set(int(f) for f in np.unique(fids))
        out.append(PacketStream(
            f"{stream.scenario}@sw{s}", stream.packets[mask],
            stream.labels[mask], fids,
            {f: l for f, l in stream.flow_labels.items() if f in present},
            None if stream.times is None else stream.times[mask],
        ))
    return out


def compose_streams(streams, *, scenario: str | None = None) -> PacketStream:
    """Merge time-stamped streams back into one arrival-ordered stream
    (the inverse of ``switch_streams`` up to same-timestamp cross-flow
    ties).  Flow labels merge with attack (1) winning on collision."""
    streams = list(streams)
    if not streams:
        raise ValueError("need at least one stream to compose")
    if any(s.times is None for s in streams):
        raise ValueError("compose_streams requires timestamped streams")
    packets = np.concatenate([s.packets for s in streams])
    labels = np.concatenate([s.labels for s in streams])
    fids = np.concatenate([s.flow_ids for s in streams])
    times = np.concatenate([s.times for s in streams])
    order = np.argsort(times, kind="stable")
    flow_labels: dict = {}
    for s in streams:
        for f, l in s.flow_labels.items():
            flow_labels[f] = max(flow_labels.get(f, 0), l)
    name = scenario or streams[0].scenario.split("@", 1)[0]
    return PacketStream(name, packets[order], labels[order], fids[order],
                        flow_labels, times=times[order])


# ------------------------------------- windowed stats + heuristic labeling


def windowed_flow_stats(stream: PacketStream, *,
                        window_s: float = 1.0) -> dict:
    """Ryu-controller-style stat collection: aggregate the stream into
    per-(time-window, flow) rows.  Returns a dict of equal-length arrays:
    ``window``, ``flow_id``, ``pkt_count``, ``byte_count``, ``mean_len``,
    ``mean_ipt`` (gap sum / packet count, first-packet gap counted as 0).
    Requires timestamps and flow ids < 2^21 (``make_stream`` guarantees
    both)."""
    if stream.times is None:
        raise ValueError("windowed_flow_stats requires timestamped streams")
    if stream.n_packets == 0:
        z = np.zeros(0)
        return {"window": z.astype(np.int64), "flow_id": z.astype(np.int64),
                "pkt_count": z.astype(np.int64), "byte_count": z,
                "mean_len": z, "mean_ipt": z}
    t = stream.times
    win = np.floor((t - t[0]) / float(window_s)).astype(np.int64)
    fid = stream.flow_ids.astype(np.int64)
    if fid.max() >= (1 << 21):
        raise ValueError("flow ids must be < 2^21 for windowed aggregation")
    code = win * (1 << 21) + fid
    uniq, inv = np.unique(code, return_inverse=True)
    count = np.bincount(inv)
    byte = np.bincount(inv, weights=stream.packets[:, COL_LEN].astype(np.float64))
    iptsum = np.bincount(inv, weights=stream.packets[:, COL_IPT].astype(np.float64))
    return {
        "window": uniq >> 21,
        "flow_id": uniq & ((1 << 21) - 1),
        "pkt_count": count.astype(np.int64),
        "byte_count": byte,
        "mean_len": byte / count,
        "mean_ipt": iptsum / count,
    }


def auto_label(stats: dict, *, flood_ipt_s: float = 4e-3,
               flood_min_pkts: int = 10, volume_min_pkts: int = 450,
               scan_max_pkts: int = 3, scan_max_len: float = 80.0) -> dict:
    """Heuristic ground-truth labeling from windowed flow stats -> dict of
    flow_id -> {0, 1}.  Three rules, each with analytic margin against the
    benign generators in ``_benign_flows``:

      flood   mean gap < ``flood_ipt_s`` over >= ``flood_min_pkts``
              packets (benign bulk floors at ~10 ms gaps, floods run
              <= 2.7 ms)
      volume  total packets >= ``volume_min_pkts`` (benign bulk tops out
              at 300; elephants and stealth-drift flows start at 500)
      scan    <= ``scan_max_pkts`` packets of <= ``scan_max_len`` bytes
              (benign flows all run >= 8 packets)
    """
    fid = np.asarray(stats["flow_id"])
    count = np.asarray(stats["pkt_count"], np.float64)
    byte = np.asarray(stats["byte_count"], np.float64)
    iptsum = np.asarray(stats["mean_ipt"], np.float64) * count
    flows, inv = np.unique(fid, return_inverse=True)
    total = np.bincount(inv, weights=count)
    mean_len = np.bincount(inv, weights=byte) / total
    mean_ipt = np.bincount(inv, weights=iptsum) / total
    is_flood = (mean_ipt < flood_ipt_s) & (total >= flood_min_pkts)
    is_volume = total >= volume_min_pkts
    is_scan = (total <= scan_max_pkts) & (mean_len <= scan_max_len)
    label = (is_flood | is_volume | is_scan).astype(np.int64)
    return {int(f): int(l) for f, l in zip(flows, label)}


# -------------------------------------------------------- reaction metrics


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
