"""Checkpointing: atomic step directories, rolling, with async save.

Counterpart of ``repro.checkpoint.manager`` for dicts of numpy arrays and
tensors (nested dicts allowed) instead of jax trees.  The layout on disk is
the reference's, byte for byte, so a checkpoint written by either package
loads in the other:

    <dir>/step_<N:08d>/manifest.json   {"step", "leaves": [{path, shape, dtype}]}
    <dir>/step_<N:08d>/arr_<i>.npy     leaf i as raw bytes (a uint8 vector)
    <dir>/step_<N:08d>/.complete       commit marker, written last

Leaves are numbered in sorted-key order and named by jax's ``keystr`` of
their key path (``"['name']"``, ``"['outer']['inner']"``), as
``jax.tree_util`` flattens a dict.  Writes go to ``step_<N>.tmp``, which is
renamed only after the marker exists, so a writer that dies mid-write never
leaves a checkpoint that ``latest_step`` would pick up.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

# a well-formed step entry: ``step_<digits>``; anything else under the
# directory (a stray file, a crashed writer's ``.tmp``) is not a checkpoint
_STEP_RE = re.compile(r"step_(\d+)$")

# torch dtypes numpy has no name for, by the name the reference writes
_TORCH_ONLY = {torch.bfloat16: "bfloat16"}
_TORCH_BY_NAME = {name: dt for dt, name in _TORCH_ONLY.items()}


def _step_of(name: str) -> int | None:
    """Step number of a well-formed ``step_<N>`` entry name, else None."""
    m = _STEP_RE.fullmatch(name)
    return int(m.group(1)) if m else None


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(keystr path, leaf) pairs of a dict in jax's flattening order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += _flatten(tree[key], f"{prefix}['{key}']")
    return out


def _host_leaf(leaf) -> tuple[np.ndarray, list[int], str]:
    """(raw bytes, shape, dtype name) of one leaf.  A tensor is copied to
    the host; a numpy array is used as it is (callers whose arrays keep
    changing hand over copies, as ``core.persistence`` does)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        name = _TORCH_ONLY.get(t.dtype)
        if name is not None:  # numpy cannot hold it: keep its bytes
            return t.reshape(-1).view(torch.uint8).numpy(), list(t.shape), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return raw, list(arr.shape), str(arr.dtype)


def _write(directory: str, step: int, leaves) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (path, (raw, shape, dtype)) in enumerate(leaves):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), raw)
        manifest["leaves"].append({"path": path, "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    open(os.path.join(tmp, ".complete"), "w").close()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_leaves(tree) -> list[tuple[str, tuple]]:
    return [(path, _host_leaf(leaf)) for path, leaf in _flatten(tree)]


def save(directory: str, step: int, tree) -> str:
    """Atomic, synchronous checkpoint of a dict of arrays and tensors; it
    returns once the renamed ``step_<N>`` directory is on disk."""
    return _write(directory, step, _host_leaves(tree))


def latest_step(directory: str) -> int | None:
    """Largest step with a committed (``.complete``-marked) directory;
    malformed entries and ``.tmp`` staging directories are ignored."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        step = _step_of(name)
        if step is not None and os.path.exists(os.path.join(directory, name, ".complete")):
            steps.append(step)
    return max(steps) if steps else None


def _manifest(directory: str, step: int) -> tuple[str, dict]:
    src = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(src, ".complete")):
        raise FileNotFoundError(f"no committed checkpoint at {src}")
    with open(os.path.join(src, "manifest.json")) as f:
        return src, json.load(f)


def load_flat(directory: str, step: int) -> dict[str, np.ndarray]:
    """Load a checkpoint saved from a FLAT ``{name: array}`` dict as numpy
    arrays, shapes and dtypes from the manifest alone (the engine
    persistence path: the caller need not know the geometry); a leaf of a
    dtype numpy has no name for (bfloat16) comes back as a CPU tensor.
    Raises ``FileNotFoundError`` if the step or its marker is missing."""
    src, manifest = _manifest(directory, step)
    out: dict[str, np.ndarray | torch.Tensor] = {}
    for i, meta in enumerate(manifest["leaves"]):
        m = re.fullmatch(r"\['([^']+)'\]", meta["path"])
        name = m.group(1) if m else meta["path"]
        raw = np.load(os.path.join(src, f"arr_{i}.npy"))
        saved = _TORCH_BY_NAME.get(meta["dtype"])
        leaf = (torch.from_numpy(raw).view(saved) if saved is not None
                else raw.view(np.dtype(meta["dtype"])))
        out[name] = leaf.reshape(meta["shape"])
    return out


def restore(directory: str, step: int, like_tree, device=None):
    """Restore into the structure of ``like_tree`` (a dict of tensors or
    arrays): tensors of each like leaf's dtype, on ``device`` (``None``:
    each like leaf's own device, the CPU for arrays)."""
    src, manifest = _manifest(directory, step)
    flat = _flatten(like_tree)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"target tree has {len(flat)}")
    out = {}
    for i, ((path, like), meta) in enumerate(zip(flat, manifest["leaves"])):
        if path != meta["path"]:
            raise ValueError(f"leaf order mismatch at {i}: {path} vs {meta['path']}")
        if list(meta["shape"]) != list(like.shape):
            raise ValueError(f"{path}: checkpoint shape {meta['shape']} != {list(like.shape)}")
        raw = torch.from_numpy(np.load(os.path.join(src, f"arr_{i}.npy")))
        saved = _TORCH_BY_NAME.get(meta["dtype"])
        t = (raw.view(saved) if saved is not None else
             torch.from_numpy(raw.numpy().view(np.dtype(meta["dtype"]))))
        t = t.reshape(meta["shape"])
        like_t = like if isinstance(like, torch.Tensor) else torch.from_numpy(np.asarray(like))
        dev = device if device is not None else like_t.device
        node = out
        keys = re.findall(r"\['([^']+)'\]", path)
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = t.to(dtype=like_t.dtype).to(dev)
    return out


class CheckpointManager:
    """Rolling checkpoints with async save and resume.

    A failed async write is never silent: its exception re-raises at the
    next ``wait()`` / ``save_async()`` / ``save_sync()``, once, and the
    manager stays usable for a retry."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Block until the in-flight async save (if any) finishes; re-raise
        the error it hit, once."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree):
        """Copy every leaf to the host NOW, in the caller's thread, then
        write on a worker thread.  Raises here if the previous async save
        failed."""
        self.wait()
        leaves = _host_leaves(tree)

        def work():
            try:
                _write(self.directory, step, leaves)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced at the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree):
        self.wait()
        save(self.directory, step, tree)
        self._gc()

    def latest_step(self):
        return latest_step(self.directory)

    def restore(self, like_tree, step: int | None = None, device=None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return restore(self.directory, step, like_tree, device=device)

    def _gc(self):
        stale_tmp, steps = [], []
        for n in os.listdir(self.directory):
            if n.endswith(".tmp") and _step_of(n[: -len(".tmp")]) is not None:
                stale_tmp.append(n)
                continue
            s = _step_of(n)
            if s is not None and os.path.exists(os.path.join(self.directory, n, ".complete")):
                steps.append(s)
        # a crashed writer's marker-less step_<N>.tmp is invisible to
        # latest_step but would leak disk forever: reap it
        for n in stale_tmp:
            shutil.rmtree(os.path.join(self.directory, n), ignore_errors=True)
        for s in sorted(steps)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
