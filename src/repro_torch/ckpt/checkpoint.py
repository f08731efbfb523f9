"""Integrity-checked, async checkpointing (counterpart of
``repro.ckpt.checkpoint``), with the reference's layout and guarantees.

Layout:
  <dir>/step_<N>/manifest.json      leaf index: path, shape, dtype, crc32,
                                    and the codec
  <dir>/step_<N>/leaf_<i>.bin.zst   compressed raw array bytes
  <dir>/step_<N>/COMPLETE           atomic finalize marker (written last)
  <dir>/latest                      text file with newest complete step

The reference writes its manifest with msgpack and compresses with zstd
where it can; the card's machine has neither module, so the manifest is
JSON and the codec zlib (recorded in the manifest), both from the
standard library.  Leaves are numbered in ``common.pytree``'s fixed
order; a bf16 leaf goes to disk as its raw 2-byte words under the dtype
name ``"bfloat16"``.

Fault-tolerance properties:
  * a crashed save never corrupts restore (COMPLETE marker is last);
  * crc32 per leaf detects bit-rot / truncation;
  * restore places each leaf on the device of ``like_tree``'s leaf, or
    on ``device``: a checkpoint written on the card restores onto the
    CPU and back (the one-card form of the reference's elastic
    re-placement onto another mesh).

AsyncCheckpointer overlaps serialization with training: the host copy on
the calling thread (device ops stay on it, and the training step may
update the state in place right after), the write and the keep-N
garbage collection on one background thread; ``wait()`` before the next
save or at exit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.common.pytree import (
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_path_str,
    tree_paths,
)

_CODEC = "zlib"
_LEVEL = 3


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf's bytes as a numpy array (bf16 as its uint16 words) and its
    dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_raw(raw: bytes, dtype: str, shape, device) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def save_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Blocking save. Returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    manifest = {"leaves": [], "step": step, "codec": _CODEC}
    for i, (path, leaf) in enumerate(zip(tree_paths(state),
                                         tree_leaves(state))):
        arr, dtype = _host(leaf)
        raw = arr.tobytes()
        fname = f"leaf_{i:05d}.bin.zst"
        with open(os.path.join(tmp_dir, fname), "wb") as f:
            f.write(zlib.compress(raw, _LEVEL))
        manifest["leaves"].append({
            "file": fname, "path": tree_path_str(path),
            "shape": list(arr.shape), "dtype": dtype,
            "crc32": zlib.crc32(raw)})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    return step_dir


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if not os.path.exists(
            os.path.join(ckpt_dir, f"step_{step:010d}", "COMPLETE")):
        # fall back: scan for newest complete step
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")
            and os.path.exists(os.path.join(ckpt_dir, d, "COMPLETE")))
        return steps[-1] if steps else None
    return step


def restore_checkpoint(ckpt_dir: str, like_tree, step: int | None = None,
                       device=None):
    """Restore into the structure of ``like_tree`` -> (tree, step).  Each
    leaf lands on ``device`` or, without one, on the device of
    ``like_tree``'s leaf; a leaf whose crc32 or shape does not match
    raises."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("codec") != _CODEC:
        raise IOError(f"unknown checkpoint codec {manifest.get('codec')!r}")
    like = tree_leaves(like_tree)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"tree wants {len(like)}")
    out = {}
    for path, ref, meta in zip(tree_paths(like_tree), like,
                               manifest["leaves"]):
        with open(os.path.join(step_dir, meta["file"]), "rb") as f:
            raw = zlib.decompress(f.read())
        if zlib.crc32(raw) != meta["crc32"]:
            raise IOError(f"crc mismatch in {meta['file']} (corrupt ckpt)")
        if list(ref.shape) != meta["shape"]:
            raise ValueError(f"{meta['path']}: checkpoint shape "
                             f"{meta['shape']}, tree {list(ref.shape)}")
        dev = device if device is not None else getattr(ref, "device", "cpu")
        out[path] = _from_raw(raw, meta["dtype"], meta["shape"], dev)
    return tree_map_with_path(lambda path, _: out[path], like_tree), step


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, state, step: int):
        self.wait()
        # the host copy on the calling thread: a copy even of a CPU tensor,
        # since the train step updates its state in place
        host_state = tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.array(x), state)

        def work():
            save_checkpoint(self.ckpt_dir, host_state, step)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.ckpt_dir) if d.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)
