"""Checkpointing in the reference's on-disk format: atomic, with an
asynchronous writer.

A checkpoint is ``<dir>/step-%08d/`` holding ``arrays.npz`` (every leaf,
keyed by its key path joined with ``/`` in the reference's flatten order)
and ``manifest.json`` (step, sorted keys, extra).  Writes go to
``<dir>/tmp-<step>`` and are renamed into place, so a crash never leaves a
half-written step.  A checkpoint written by either package restores in the
other: bf16 leaves are stored as the reference stores them (their two
bytes as numpy's ``V2``) and read back as bf16.

Checkpoints hold full leaves whatever mesh wrote them (a data-parallel
``train`` gathers its shards and writes from rank 0).
``restore(shardings=)`` is the reference's elastic re-shard on load: each
full leaf is cut to this rank's shard of the current mesh, so a
checkpoint written under one mesh restores under another, or in one
process.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..sharding import shard_tree
from ..tree import tree_from_items, tree_items

__all__ = ["save", "latest_step", "restore", "AsyncCheckpointer"]

SEP = "/"


def _key(path: tuple) -> str:
    return SEP.join(str(k) for k in path)


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` that owns its memory (a CPU tensor's
    ``.numpy()`` would share it with the tensor the optimizer updates in
    place)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_host(a: np.ndarray, like: torch.Tensor, sharding=None) -> torch.Tensor:
    if a.dtype == np.dtype("V2") or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if sharding is not None:
        t = shard_tree(t, sharding)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a "
                         f"leaf of shape {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _write(directory: str, step: int, host: dict, extra: dict | None) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {"step": step, "keys": sorted(host), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _snapshot(tree) -> dict:
    return {_key(path): _to_host(leaf) for path, leaf in tree_items(tree)}


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` (nested dicts of tensors or arrays) as step ``step``;
    returns the checkpoint's directory."""
    return _write(directory, step, _snapshot(tree), extra)


def _steps(directory: str) -> list[int]:
    return sorted(int(d.split("-")[1]) for d in os.listdir(directory)
                  if d.startswith("step-"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like_tree, shardings=None):
    """The checkpoint of ``step`` in the structure of ``like_tree``, each
    leaf on the device and in the dtype of its counterpart there.  With
    ``shardings`` (a tree like ``like_tree`` of ``sharding.
    NamedSharding``, as ``schema_shardings`` gives) each full leaf is cut
    to this rank's shard first, and ``like_tree`` holds the shards."""
    path = os.path.join(directory, f"step-{step:08d}", "arrays.npz")
    cuts = None if shardings is None else dict(tree_items(shardings))
    with np.load(path) as data:
        items = [(p, _from_host(data[_key(p)], like,
                                None if cuts is None else cuts[p]))
                 for p, like in tree_items(like_tree)]
    return tree_from_items(items)


class AsyncCheckpointer:
    """One-slot asynchronous writer: ``submit`` copies the tree to the host
    before it returns, then writes on a background thread (a previous
    write is joined first, so at most one is in flight); ``keep`` newest
    checkpoints stay."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def submit(self, step: int, tree, extra=None) -> None:
        self.wait()
        # the snapshot is taken here, synchronously: the optimizer updates
        # the params and moments in place as soon as this returns
        host = _snapshot(tree)

        def work():
            try:
                _write(self.directory, step, host, extra)
                self._gc()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)
