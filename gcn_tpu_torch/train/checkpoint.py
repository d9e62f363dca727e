"""Checkpoints in gcn_tpu's format: parameters, optimizer state, config and
step metadata (counterpart of ``gcn_tpu.train.checkpoint``).

A checkpoint is a directory::

    <dir>/params.msgpack      flax-serialized parameter tree
    <dir>/opt_state.msgpack   optax state tree (optional)
    <dir>/meta.json           {"config": cfg.to_dict(), "meta": {...}}

The ``.msgpack`` files are written and read by ``train.flax_msgpack``, so
either package reads what the other wrote.  Trees here are nested dicts of
numpy arrays on the host.  Writes are atomic (a ``.tmp`` directory, then a
rename).  ``async_save=True`` writes on a background thread that first
waits for the write before it, so saves land in the order they were made;
``wait_for_async_saves()`` joins the newest, and with it every earlier one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

from gcn_tpu_torch.train import flax_msgpack

_async_thread: Optional[threading.Thread] = None


def save_checkpoint(
    directory: str,
    params: Any,
    opt_state: Any = None,
    config: Optional[dict] = None,
    meta: Optional[dict] = None,
    async_save: bool = False,
) -> None:
    """Atomic checkpoint write (tmp dir + rename) of trees of host numpy
    arrays, which the caller leaves unchanged (``Trainer.save`` passes
    fresh copies); with ``async_save`` the files are written on a
    thread."""

    global _async_thread
    prev = _async_thread

    def write():
        if prev is not None:  # the saves before this one land first
            prev.join()
        d = os.path.abspath(directory)
        os.makedirs(os.path.dirname(d), exist_ok=True)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "params.msgpack"), "wb") as f:
            f.write(flax_msgpack.to_bytes(params))
        if opt_state is not None:
            with open(os.path.join(tmp, "opt_state.msgpack"), "wb") as f:
                f.write(flax_msgpack.to_bytes(opt_state))
        blob = {"config": config or {}, "meta": meta or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(blob, f, indent=2, default=str)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        _async_thread = t
        t.start()
    else:
        write()


def wait_for_async_saves() -> None:
    """Block until every in-flight async checkpoint write has landed."""
    t = _async_thread
    if t is not None:
        t.join()


def load_checkpoint(directory: str, load_opt_state: bool = True
                    ) -> tuple[dict, Optional[dict], dict]:
    """(params tree, optimizer state tree or None, meta blob) of a
    checkpoint directory, as numpy arrays."""
    with open(os.path.join(directory, "params.msgpack"), "rb") as f:
        params = flax_msgpack.from_bytes(f.read())
    opt_state = None
    opt_path = os.path.join(directory, "opt_state.msgpack")
    if load_opt_state and os.path.exists(opt_path):
        with open(opt_path, "rb") as f:
            opt_state = flax_msgpack.from_bytes(f.read())
    with open(os.path.join(directory, "meta.json")) as f:
        blob = json.load(f)
    return params, opt_state, blob


def load_checkpoint_config(directory: str) -> dict:
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)["config"]
