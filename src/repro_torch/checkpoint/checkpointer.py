"""Fault-tolerant checkpointing: async, atomic, keep-k, resumable.

The port of ``repro.checkpoint.checkpointer``, with its on-disk layout, so
each package reads the other's checkpoints:

* each save writes the tree to ``step_<N>.npz``, one entry per leaf keyed
  by its tree path (dict keys and list/tuple indices joined with ``/``,
  stored with ``||`` in place of ``/``; ``None`` leaves are left out, as
  JAX's tree flattening leaves them out); a bf16 leaf is stored as its
  ``uint16`` bit pattern under ``<key>@@bfloat16``;
* the tree is copied to the host synchronously in ``save`` (a tensor on
  the card by a blocking copy, a CPU tensor or an array by a clone, since
  the training step updates parameters and moments in place); a
  background thread then writes ``.tmp`` and ``os.replace``s it, so a
  crashed save never corrupts the latest good checkpoint;
* ``MANIFEST.json`` records the latest durable step; readers trust it
  over the directory listing;
* keep-k garbage collection;
* an optional pickled ``aux`` state dict (engine clocks, cursors, RNG
  state) rides in the same npz under ``__aux_state__``; it must hold only
  Python and numpy values, so either package can unpickle it.

``restore(template)`` rebuilds the template's structure with each leaf of
the template's kind and dtype: a tensor on ``device`` (or the template
leaf's device), a numpy array, or a Python scalar.
"""
from __future__ import annotations

import json
import os
import pickle
import threading
from pathlib import Path

import numpy as np
import torch

# Reserved npz key carrying the pickled engine/aux state dict of a save.
_AUX_KEY = "__aux_state__"
_BF16 = "bfloat16"
_SAFE = {np.dtype(t) for t in ("f8", "f4", "f2", "i8", "i4", "i2", "i1",
                               "u8", "u4", "u2", "u1", "?")}


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples, in
    order; ``None`` leaves are skipped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_host(leaf) -> tuple[np.ndarray, str | None]:
    """A host copy of a leaf, and ``"bfloat16"`` when it is bf16 (then
    the copy is its uint16 bit pattern)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.array(leaf, copy=True), None


def _flatten(tree) -> dict[str, np.ndarray]:
    """``{key: host array}``; a bf16 leaf's key carries ``@@bfloat16``."""
    flat = {}
    for path, leaf in _paths(tree):
        arr, tag = _to_host(leaf)
        flat[_key(path) + (f"@@{tag}" if tag else "")] = arr
    return flat


def _leaf_like(template, arr: np.ndarray, bf16: bool, device):
    if isinstance(template, torch.Tensor):
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if bf16 else torch.from_numpy(arr))
        return t.to(device=device if device is not None
                    else template.device, dtype=template.dtype, copy=True)
    if isinstance(template, np.ndarray):
        if bf16:
            arr = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).float().numpy()
        return np.asarray(arr, dtype=template.dtype)
    return type(template)(arr.item() if arr.ndim == 0 else arr)


def _rebuild(template, flat, device, prefix=()):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, device, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, flat, device, prefix + (i,))
               for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    arr, bf16 = flat[_key(prefix)]
    return _leaf_like(template, arr, bf16, device)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = False,
             aux: dict | None = None) -> None:
        """Snapshot to the host, then write in the background.

        ``aux`` is an optional picklable state dict stored inside the same
        npz, so a step-exact resume needs no sidecar files and inherits
        the write's atomicity.
        """
        flat = _flatten(tree)   # every host copy is complete here
        if aux is not None:
            flat[_AUX_KEY] = np.frombuffer(pickle.dumps(aux), dtype=np.uint8)
        self.wait()             # one in-flight save at a time
        t = threading.Thread(target=self._write, args=(step, flat),
                             daemon=True)
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> None:
        tmp = self.dir / f"step_{step}.npz.tmp"
        final = self.dir / f"step_{step}.npz"
        ser = {}
        for k, v in flat.items():
            if v.dtype not in _SAFE:
                raise TypeError(f"checkpoint leaf {k!r} has dtype {v.dtype}")
            ser[k.replace("/", "||")] = v
        with open(tmp, "wb") as f:
            np.savez(f, **ser)
        os.replace(tmp, final)  # atomic
        manifest = self.dir / "MANIFEST.json"
        mtmp = self.dir / "MANIFEST.json.tmp"
        mtmp.write_text(json.dumps({"latest_step": step}))
        os.replace(mtmp, manifest)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            try:
                (self.dir / f"step_{s}.npz").unlink()
            except FileNotFoundError:
                pass

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------ restore
    def all_steps(self) -> list[int]:
        return [int(p.stem.split("_")[1]) for p in self.dir.glob("step_*.npz")]

    def latest_step(self) -> int | None:
        m = self.dir / "MANIFEST.json"
        if m.exists():
            step = json.loads(m.read_text()).get("latest_step")
            if step is not None and (self.dir / f"step_{step}.npz").exists():
                return step
        steps = self.all_steps()
        return max(steps) if steps else None

    def load_aux(self, step: int | None = None) -> dict | None:
        """The aux state dict saved alongside a checkpoint, or None (saves
        without aux)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        with np.load(self.dir / f"step_{step}.npz") as z:
            if _AUX_KEY not in z.files:
                return None
            return pickle.loads(z[_AUX_KEY].tobytes())

    def _load_flat(self, step: int | None = None
                  ) -> tuple[int, dict[str, tuple[np.ndarray, bool]]]:
        """(step, ``{key: (array, is_bf16)}``) of a checkpoint; a bf16
        leaf's array is its uint16 bit pattern."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        flat = {}
        with np.load(self.dir / f"step_{step}.npz") as z:
            for k in z.files:
                if k == _AUX_KEY:
                    continue
                v, bf16 = z[k], False
                if "@@" in k:
                    k, dtn = k.split("@@")
                    bf16 = dtn == _BF16 and v.dtype == np.uint16
                    if dtn != _BF16:
                        v = v.astype(np.float32)
                flat[k.replace("||", "/")] = (v, bf16)
        return step, flat

    def restore(self, template, step: int | None = None, device=None):
        """Returns (step, tree): the template's structure, each leaf of the
        template leaf's kind and dtype (tensors on ``device``, or where
        the template leaf is)."""
        step, flat = self._load_flat(step)
        return step, _rebuild(template, flat, device)
