"""Checkpointing: atomic manifests, async save, restore onto a device.

PyTorch port of ``repro.checkpoint.manager`` with the same layout, so the
two packages read each other's checkpoints:

    <dir>/step_000123/
        manifest.json   (step, time, and per leaf its shape, dtype and
                         sha256 -- written LAST; a directory without a
                         manifest is garbage by definition => crash-atomic)
        <leafkey>.npy   one file per leaf of the nested dict

A leaf's key joins its dict keys with ``__`` (the JAX package's
``_leaf_key``).  A step is written into ``step_%06d.tmp`` and renamed
into place; ``keep`` prunes the oldest.  ``async_save`` takes the host
snapshot before the writer thread starts, so the caller may update the
tensors in place at once.  bfloat16 leaves are written as their 2-byte
bits (numpy void ``V2``, as ``np.save`` stores JAX's bfloat16) with
"bfloat16" in the manifest, and restored by that dtype.  (The JAX
package's restore cannot read such a leaf back: ROADMAP C.)

Sharded trees (each leaf this rank's block on a ``launch.mesh.Mesh``)
pass ``shardings=(mesh, specs)``, ``specs`` a tree of spec tuples like
the tree: ``save`` gathers the full leaves (``unshard_tree``, one leaf at
a time) and rank 0 writes them, in the same files and manifest, then
every rank meets at a barrier; ``restore`` gives each rank its block for
a target mesh and specs, whatever mesh wrote the files (JAX's
``restore(shardings=)``).  ``reshard`` moves a live tree between two
meshes over the same world.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.sharding import (block, gather_leaf, mesh_coords,
                                         shard_slices)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a nested dict, keys sorted as JAX flattens a dict."""
    for k in sorted(tree):
        v = tree[k]
        path = prefix + (str(k),)
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield "__".join(path), v


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` (tensor or array) on the host, and its dtype's
    name in the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).cpu().numpy()
            return np.array(bits).view("V2"), "bfloat16"
        arr = np.array(t.cpu().numpy())
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict[str, Any],
             shardings: Optional[Tuple[Any, Dict[str, Any]]] = None) -> str:
        """Write ``tree`` (a nested dict of tensors or arrays) as ``step``.
        With ``shardings=(mesh, specs)`` the leaves are this rank's blocks:
        every rank gathers each full leaf, rank 0 writes (synchronously),
        then all meet at a barrier.  Returns the step's directory."""
        self.wait()
        if shardings is not None:
            mesh, specs = shardings
            flat = dict(_leaves(specs))
            host = []
            with torch.no_grad():
                for key, leaf in _leaves(tree):
                    full = gather_leaf(leaf, flat[key], mesh)
                    if mesh.rank == 0:
                        host.append((key, *_to_host(full)))
                    del full
            if mesh.rank == 0:
                self._write(step, host)
            dist.barrier()
            return self._step_dir(step)
        # snapshot on the host BEFORE going async
        host = [(key, *_to_host(leaf)) for key, leaf in _leaves(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)
        return self._step_dir(step)

    def _write_async(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except Exception as e:   # re-raised by wait()
            self._error = e

    def _write(self, step: int, host) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                    "leaves": {}}
        for key, arr, dtype in host:
            fp = os.path.join(tmp, key + ".npy")
            np.save(fp, arr)
            manifest["leaves"][key] = {
                "shape": list(arr.shape), "dtype": dtype,
                "sha256": _sha256(fp),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._prune()

    def wait(self) -> None:
        """Join an async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Dict[str, Any], step: Optional[int] = None,
                device=None, verify: bool = True,
                shardings: Optional[Tuple[Any, Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
        """Restore into the structure of ``like`` (a nested dict whose
        leaves are only read for their device): each leaf with the dtype
        its manifest records, on ``device``, or else on the device of
        ``like``'s leaf (the CPU for a leaf that is not a tensor).  With
        ``shardings=(mesh, specs)`` each leaf is this rank's block of it on
        ``mesh`` (the file read through a memory map, only the block
        copied), on ``device`` or else the mesh's device.  ``verify``
        checks each file's sha256 and raises ``IOError`` on a mismatch."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints in " + self.dir)
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if shardings is not None:
            mesh, specs = shardings
            flat = dict(_leaves(specs))
            coords = mesh_coords(mesh)
            device = device if device is not None else mesh.device

        def read(fp, key):
            if shardings is None:
                return np.load(fp)
            arr = np.load(fp, mmap_mode="r")
            return np.array(arr[shard_slices(arr.shape, flat[key], mesh,
                                             coords)])

        def load(sub, prefix):
            out = {}
            for k, v in sub.items():
                path = prefix + (str(k),)
                if isinstance(v, dict):
                    out[k] = load(v, path)
                    continue
                key = "__".join(path)
                fp = os.path.join(d, key + ".npy")
                meta = manifest["leaves"][key]
                if verify and _sha256(fp) != meta["sha256"]:
                    raise IOError(f"checkpoint corruption in {fp}")
                dev = device if device is not None else (
                    v.device if isinstance(v, torch.Tensor) else "cpu")
                out[k] = _from_host(read(fp, key), meta["dtype"]).to(dev)
            return out

        return load(like, ())

    # ----------------------------------------------------------------- misc
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:06d}")

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def reshard(tree: Dict[str, Any], specs: Dict[str, Any], mesh,
            new_specs: Dict[str, Any], new_mesh) -> Dict[str, Any]:
    """Elastic re-mesh of a live tree: its leaves, this rank's blocks under
    ``specs`` on ``mesh``, gathered whole one at a time and cut to this
    rank's blocks under ``new_specs`` on ``new_mesh``, a mesh over the same
    world (a torch world cannot grow: (2, 2) -> (1, 4), say).  On
    ``new_mesh``'s device."""
    coords = mesh_coords(new_mesh)

    def move(t, sp, nsp):
        with torch.no_grad():
            full = gather_leaf(t, sp, mesh)
            return block(full, nsp, new_mesh, coords).to(new_mesh.device)

    def walk(t, sp, nsp):
        if isinstance(t, dict):
            return {k: walk(t[k], sp[k], nsp[k]) for k in t}
        return move(t, sp, nsp)

    return walk(tree, specs, new_specs)
