"""Synthetic network datasets mirroring the paper's three applications.

A copy of ``repro.data.netdata`` (numpy only), kept in the port so that it
imports nothing of the reference package; the same seed gives the same
arrays in both.

The paper's datasets (NSL-KDD [23], IIsy IoT traces [96], PeerRush P2P [77])
are not available offline; these generators synthesize statistically faithful
replicas (seeded, deterministic).  Design goals, in order:

  1. *Capacity -> accuracy correlation.*  Class boundaries are nonlinear and
     multi-modal (mixture components + feature interactions), so a small
     hand-tuned DNN underfits and a larger BO-found model measurably improves
     F1 -- the paper's central Table-2 effect.
  2. *Feature-subset degradation.*  Dropping features loses information
     gracefully (IIsy/MAT backend removes "less impactful features" to fit).
  3. *Botnet reactivity* (paper Fig. 6 / §5.1.1): botnet flows are
     low-volume / high-duration vs benign P2P, so *partial* per-packet
     histograms diverge early, and per-packet F1 approaches flow-level F1
     well before flow end.

Absolute F1 values therefore differ from the paper; every relative claim is
reproducible (see benchmarks/table2_f1.py et al.).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ------------------------------------------------------------------ common


@dataclasses.dataclass
class Dataset:
    """Feature-matrix dataset with train/test split."""

    name: str
    train_x: np.ndarray  # [N, F] float32
    train_y: np.ndarray  # [N] int32
    test_x: np.ndarray
    test_y: np.ndarray
    feature_names: list[str]
    num_classes: int

    @property
    def num_features(self) -> int:
        return self.train_x.shape[1]

    def fingerprint(self) -> str:
        """Content hash of what training sees (train split + class count) —
        the dataset half of the trained-candidate cache key.  Computed once
        and memoized on the instance; arrays are treated as immutable after
        construction (everything in this repo copies instead of mutating)."""
        if getattr(self, "_fingerprint", None) is None:
            import hashlib

            h = hashlib.sha1()
            for a in (self.train_x, self.train_y):
                a = np.ascontiguousarray(a)
                h.update(str(a.shape).encode())
                h.update(str(a.dtype).encode())
                h.update(a.tobytes())
            h.update(str(self.num_classes).encode())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    def subset_features(self, idx: list[int]) -> "Dataset":
        return Dataset(
            name=f"{self.name}[{len(idx)}f]",
            train_x=self.train_x[:, idx],
            train_y=self.train_y,
            test_x=self.test_x[:, idx],
            test_y=self.test_y,
            feature_names=[self.feature_names[i] for i in idx],
            num_classes=self.num_classes,
        )

    def split_half(self, seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """Split the training rows in two (model-fusion experiment, Table 4)."""
        rng = np.random.default_rng(seed)
        n = len(self.train_x)
        perm = rng.permutation(n)
        a, b = perm[: n // 2], perm[n // 2:]
        mk = lambda part, rows: Dataset(
            name=f"{self.name}-{part}",
            train_x=self.train_x[rows],
            train_y=self.train_y[rows],
            test_x=self.test_x,
            test_y=self.test_y,
            feature_names=self.feature_names,
            num_classes=self.num_classes,
        )
        return mk("part1", a), mk("part2", b)


def _standardize(train_x, test_x):
    mu = train_x.mean(0, keepdims=True)
    sd = train_x.std(0, keepdims=True) + 1e-6
    return (train_x - mu) / sd, (test_x - mu) / sd


# ------------------------------------------------- anomaly detection (AD)

_AD_FEATURES_7 = [
    "duration", "src_bytes", "dst_bytes", "count",
    "srv_count", "serror_rate", "same_srv_rate",
]

_AD_FEATURES_30 = _AD_FEATURES_7 + [f"stat_{i}" for i in range(23)]


def make_ad_dataset(
    *, features: int = 7, n_train: int = 8192, n_test: int = 4096,
    seed: int = 0,
) -> Dataset:
    """NSL-KDD-like anomaly detection: benign vs malicious (binary).

    Attack traffic is a mixture of 4 "attack families" (DoS / probe / R2L /
    U2R-like), each a distinct cluster in a rotated feature subspace, with
    pairwise feature *interactions* deciding class in two of the families --
    this is what makes small models underfit (Table 2 capacity effect).
    """
    assert features in (7, 30)
    rng = np.random.default_rng(seed)
    F = features
    n = n_train + n_test
    y = (rng.random(n) < 0.45).astype(np.int32)  # ~45% attacks

    x = rng.normal(0, 1.0, size=(n, F)).astype(np.float32)
    fam = rng.integers(0, 4, size=n)

    # family-specific mean shifts on small feature subsets
    centers = rng.normal(0, 2.2, size=(4, F)).astype(np.float32)
    mask = rng.random((4, F)) < (4.0 / F)  # each family touches ~4 features
    centers *= mask
    atk = y == 1
    x[atk] += centers[fam[atk]]

    # nonlinear structure: XOR-ish interaction between duration & src_bytes
    # and a ring in (count, srv_count) for two families
    inter = (x[:, 0] * x[:, 1] > 0.0) & np.isin(fam, (0, 1))
    x[atk & inter, 2] += 1.8
    ring = np.sqrt(x[:, 3] ** 2 + x[:, 4] ** 2)
    x[atk & np.isin(fam, (2, 3)), 5] += (2.0 - ring[atk & np.isin(fam, (2, 3))])

    # benign has its own two modes (web-ish vs bulk-ish) to avoid a trivially
    # separable unimodal benign class
    ben_mode = rng.random(n) < 0.5
    x[(~atk) & ben_mode, 0] += 1.2
    x[(~atk) & ~ben_mode, 3] -= 1.2

    # label noise + heavy-tailed measurement noise
    flip = rng.random(n) < 0.04
    y = np.where(flip, 1 - y, y)
    x += rng.standard_t(4, size=(n, F)).astype(np.float32) * 0.35

    tr_x, te_x = x[:n_train], x[n_train:]
    tr_x, te_x = _standardize(tr_x, te_x)
    names = _AD_FEATURES_7 if F == 7 else _AD_FEATURES_30
    return Dataset("anomaly_detection", tr_x.astype(np.float32),
                   y[:n_train], te_x.astype(np.float32), y[n_train:],
                   list(names), 2)


# --------------------------------------------- traffic classification (TC)

_TC_FEATURES = [
    "pkt_size", "eth_type", "ip_proto", "ip_ttl",
    "ip_tos", "src_port_bucket", "dst_port_bucket",
]

_TC_CLASSES = ["camera", "thermostat", "speaker", "bulb", "hub"]


def make_tc_dataset(
    *, n_train: int = 8192, n_test: int = 4096, seed: int = 1,
) -> Dataset:
    """IIsy-style IoT traffic classification: 5 device classes from
    packet-header features.  Each device emits 2-3 traffic modes (e.g. camera
    keepalive vs video burst), so classes are multi-modal -> clusterable by
    KMeans but better separated by a DNN."""
    rng = np.random.default_rng(seed)
    F = len(_TC_FEATURES)
    C = len(_TC_CLASSES)
    n = n_train + n_test
    y = rng.integers(0, C, size=n).astype(np.int32)

    n_modes = 3
    centers = rng.normal(0, 2.0, size=(C, n_modes, F)).astype(np.float32)
    mode_p = rng.dirichlet(np.ones(n_modes) * 1.5, size=C)
    modes = np.array(
        [rng.choice(n_modes, p=mode_p[c]) for c in y], dtype=np.int64
    )
    x = centers[y, modes] + rng.normal(0, 0.9, size=(n, F)).astype(np.float32)

    # port buckets correlate with (class, mode) but overlap across classes
    x[:, 5] = (y + modes + rng.integers(0, 2, size=n)) % C
    x[:, 6] = ((y * 2 + modes) % C) + rng.normal(0, 0.4, size=n)

    flip = rng.random(n) < 0.03
    y = np.where(flip, rng.integers(0, C, size=n), y).astype(np.int32)

    tr_x, te_x = _standardize(x[:n_train], x[n_train:])
    return Dataset("traffic_classification", tr_x.astype(np.float32),
                   y[:n_train], te_x.astype(np.float32), y[n_train:],
                   list(_TC_FEATURES), C)


# ------------------------------------------------- botnet detection (BD)

_PL_BINS = 23   # packet-length bins (paper: fused from 94 -> 23)
_IPT_BINS = 7   # inter-arrival-time bins (paper: fused to 7)
_BD_FEATURES = (
    [f"pl_bin_{i}" for i in range(_PL_BINS)]
    + [f"ipt_bin_{i}" for i in range(_IPT_BINS)]
)


@dataclasses.dataclass
class FlowTrace:
    """A single P2P flow: per-packet sizes and inter-arrival times."""

    sizes: np.ndarray  # [P] bytes
    ipts: np.ndarray   # [P] seconds
    label: int         # 1 = botnet


def _bin_edges():
    pl_edges = np.linspace(0, 1472, _PL_BINS + 1)          # 64B-ish bins
    ipt_edges = np.geomspace(1e-3, 3600.0, _IPT_BINS + 1)  # log-spaced
    return pl_edges, ipt_edges


def flow_histogram(flow: FlowTrace, upto: int | None = None) -> np.ndarray:
    """Flowmarker: normalized [PL||IPT] histogram over the first ``upto``
    packets (None = full flow).  Per-packet *partial* histograms (paper
    §5.1.1) are this with upto=k."""
    pl_edges, ipt_edges = _bin_edges()
    s = flow.sizes[:upto] if upto else flow.sizes
    t = flow.ipts[:upto] if upto else flow.ipts
    h_pl, _ = np.histogram(s, bins=pl_edges)
    h_ipt, _ = np.histogram(t, bins=ipt_edges)
    h = np.concatenate([h_pl, h_ipt]).astype(np.float32)
    return h / max(len(s), 1)


def make_bd_flows(
    *, n_flows: int = 3000, seed: int = 2,
) -> list[FlowTrace]:
    """P2P flows: botnets (Storm/Waledac-like) are low-volume/high-duration
    command-and-control chatter -- small packets, long inter-arrival gaps;
    benign P2P (uTorrent/eMule-like) is bulk transfer -- large packets, short
    gaps -- with a chatty-benign mode (DHT lookups) as the confuser."""
    rng = np.random.default_rng(seed)
    flows = []
    for _ in range(n_flows):
        botnet = rng.random() < 0.5
        if botnet:
            n_pkts = int(rng.integers(30, 150))          # low volume
            # beaconing: small keepalives + occasional command payloads;
            # deliberately close to the chatty-benign (DHT) mode so the
            # classes overlap per-packet and only the histogram SHAPE over
            # enough packets separates them (paper's gradual Fig-6 curve)
            sizes = np.where(
                rng.random(n_pkts) < 0.8,
                rng.normal(180, 70, n_pkts),
                rng.normal(420, 110, n_pkts),
            )
            ipts = rng.lognormal(np.log(9.0), 1.4, n_pkts)  # long-ish gaps
        else:
            chatty = rng.random() < 0.45
            if chatty:  # DHT-lookup mode: smallish packets, medium gaps
                n_pkts = int(rng.integers(60, 300))
                sizes = rng.normal(270, 90, n_pkts)
                ipts = rng.lognormal(np.log(3.0), 1.2, n_pkts)
            else:  # bulk transfer: MTU-sized packets, tiny gaps
                n_pkts = int(rng.integers(200, 900))
                sizes = np.where(
                    rng.random(n_pkts) < 0.8,
                    rng.normal(1380, 60, n_pkts),
                    rng.normal(600, 150, n_pkts),
                )
                ipts = rng.lognormal(np.log(0.05), 0.8, n_pkts)
        sizes = np.clip(sizes, 40, 1472).astype(np.float32)
        ipts = np.clip(ipts, 1e-3, 3600.0).astype(np.float32)
        flows.append(FlowTrace(sizes, ipts, int(botnet)))
    return flows


def make_bd_dataset(
    *, n_flows: int = 3000, test_frac: float = 0.35, seed: int = 2,
) -> tuple[Dataset, list[FlowTrace]]:
    """Training set = *full-flow* flowmarkers (as the paper trains);
    returns held-out raw test flows too, so per-packet partial-histogram
    evaluation (bd_per_packet_eval) can replay them packet by packet."""
    flows = make_bd_flows(n_flows=n_flows, seed=seed)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(len(flows))
    n_test = int(len(flows) * test_frac)
    test_idx, train_idx = perm[:n_test], perm[n_test:]

    def hist_xy(idx):
        x = np.stack([flow_histogram(flows[i]) for i in idx])
        y = np.array([flows[i].label for i in idx], np.int32)
        return x.astype(np.float32), y

    tr_x, tr_y = hist_xy(train_idx)
    te_x, te_y = hist_xy(test_idx)
    ds = Dataset("botnet_detection", tr_x, tr_y, te_x, te_y,
                 list(_BD_FEATURES), 2)
    return ds, [flows[i] for i in test_idx]


def bd_partial_eval_set(
    flows: list[FlowTrace], checkpoints: tuple[int, ...] = (5, 10, 20, 40, 80),
) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """{k: (X, y)} -- partial flowmarkers after the first k packets.  This is
    the paper's per-packet inference setting: the switch updates a register
    histogram per packet and classifies on the *partial* histogram."""
    out = {}
    for k in checkpoints:
        x = np.stack([flow_histogram(f, upto=k) for f in flows])
        y = np.array([f.label for f in flows], np.int32)
        out[k] = (x.astype(np.float32), y)
    return out


def mean_histograms(flows: list[FlowTrace]) -> dict[str, np.ndarray]:
    """Average full-flow histograms per class (paper Fig. 6)."""
    bot = np.stack([flow_histogram(f) for f in flows if f.label == 1])
    ben = np.stack([flow_histogram(f) for f in flows if f.label == 0])
    return {"botnet": bot.mean(0), "benign": ben.mean(0)}


# ------------------------------------------------------------- registry

def load(name: str, **kw):
    if name == "ad":
        return make_ad_dataset(**kw)
    if name == "ad30":
        return make_ad_dataset(features=30, **kw)
    if name == "tc":
        return make_tc_dataset(**kw)
    if name == "bd":
        return make_bd_dataset(**kw)[0]
    raise KeyError(name)
