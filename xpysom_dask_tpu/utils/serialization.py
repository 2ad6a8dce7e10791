"""Checkpoint / serialization.

The reference offers two mechanisms (SURVEY.md §5): (a) whole-object pickle
with backend re-resolution on load (reference xpysom.py:868-892), and
(b) segmented training (``iter_beg``/``iter_end``) as the resume API
(xpysom.py:470-482). Both are preserved (pickle via ``XPySom.__getstate__``;
segmentation in ``train``). This module adds what the reference lacks: a
portable on-disk checkpoint format — a single ``.npz`` with the codebook,
the RNG state and a JSON header of constructor parameters — that is
robust across library versions (no Python object graphs) and suitable for
per-epoch fault-tolerance checkpointing on long sharded runs.
"""

from __future__ import annotations

import json
import pickle

import numpy as np

__all__ = [
    "save",
    "load",
    "save_checkpoint",
    "load_checkpoint",
    "save_population_checkpoint",
    "load_population_checkpoint",
]

_FORMAT_VERSION = 1


def _norm_path(path) -> str:
    """np.savez appends '.npz' to extension-less paths; normalize both save
    and load to the same name so the documented save->resume round-trip
    works for any path."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _should_write() -> bool:
    """In a multi-process run every process holds identical (replicated)
    model state, so only process 0 writes the checkpoint — concurrent
    np.savez calls on one shared-filesystem path would interleave and
    corrupt the zip exactly when fault tolerance is needed."""
    try:
        import jax

        return jax.process_index() == 0
    except Exception:  # jax not initialized yet: single-process
        return True


def _atomic_savez(path: str, **arrays) -> None:
    """Write to a temp name then os.replace: a crash (or a concurrent
    reader) mid-write must never leave a truncated checkpoint at the
    final path — the previous complete checkpoint survives."""
    import os

    tmp = path + f".tmp.{os.getpid()}"
    try:
        np.savez(tmp, **arrays)
        # np.savez appends .npz to extension-less names
        tmp_real = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(tmp_real, path)
    except BaseException:
        for cand in (tmp, tmp + ".npz"):
            try:
                os.remove(cand)
            except OSError:
                pass
        raise


def save(som, path):
    """Pickle convenience (equivalent to the reference's pickle usage,
    tests.py:145-150)."""
    with open(path, "wb") as f:
        pickle.dump(som, f)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _config_dict(som):
    return {
        "x": som._x,
        "y": som._y,
        "input_len": som._input_len,
        "sigma": float(som._sigma),
        "sigmaN": float(som._sigmaN),
        "learning_rate": float(som._learning_rate),
        "learning_rateN": float(som._learning_rateN),
        "decay_function": som._decay_function_name,
        "neighborhood_function": som.neighborhood_func_name,
        "std_coeff": float(som._std_coeff),
        "topology": som.topology,
        "activation_distance": som._activation_distance_name,
        "activation_distance_kwargs": som._activation_distance_kwargs,
        "compact_support": bool(som.compact_support),
        # 0 = auto-sized: persisting the RESOLVED value would make the
        # loader treat it as user-explicit and drop the _matrix_chunk
        # budget on matrix-materializing paths (chunk·XY·4-byte
        # transients — ~17 GB at XY=512² with the fused default)
        "n_parallel": (
            int(som._n_parallel)
            if getattr(som, "_n_parallel_explicit", False)
            else 0
        ),
        # bmu_precision is NUMERIC semantics — it travels with the
        # checkpoint unconditionally so the reloaded model reproduces the
        # training numerics. use_pallas/bmu_tiles are HARDWARE tuning:
        # persisted only when user-explicit (the n_parallel_explicit
        # treatment), so (a) the XPYSOM_NO_PALLAS kill-switch on the
        # loading host is honored (fresh construction-time resolution)
        # and (b) blocks chosen for one card are never pinned on a card
        # whose shared memory they might exceed.
        "bmu_precision": som._bmu_precision,
        "bmu_tiles": (
            list(som._bmu_tiles)
            if som._bmu_tiles and getattr(som, "_bmu_tiles_explicit", True)
            else None
        ),
        "use_pallas": (
            bool(som._use_pallas)
            if getattr(som, "_use_pallas_explicit", True)
            else None
        ),
    }


def save_checkpoint(som, path, *, epoch=None):
    """Write a portable checkpoint: codebook + RNG state + config header.

    ``epoch`` (optional) records how many epochs of the current schedule
    have completed, so training can resume with
    ``train(data, T, iter_beg=epoch)``.
    """
    if not _should_write():
        return
    path = _norm_path(path)
    header = {
        "format_version": _FORMAT_VERSION,
        "config": _config_dict(som),
        "epoch": epoch,
    }
    rng_state = som._random_generator.get_state()
    _atomic_savez(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        weights=np.asarray(som._weights),
        rng_keys=np.asarray(rng_state[1]),
        rng_meta=np.asarray(
            [rng_state[2], rng_state[3], 0], dtype=np.float64
        ),  # pos, has_gauss, pad
        rng_gauss=np.asarray([rng_state[4]], dtype=np.float64),
    )


def load_checkpoint(path, *, mesh=None):
    """Rebuild an ``XPySom`` from a checkpoint. ``mesh`` (optional) attaches
    a device mesh on the loading host — like the reference's unpickle-time
    backend re-resolution (xpysom.py:880-892), hardware is a property of
    the host, not the checkpoint."""
    from ..models.som import XPySom

    with np.load(_norm_path(path)) as z:
        if "header" not in z.files or "weights" not in z.files:
            raise ValueError(
                f"{path!r} is not an xpysom checkpoint "
                f"(missing header/weights entries; found {z.files})"
            )
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} is newer than "
                f"this library supports ({_FORMAT_VERSION})"
            )
        cfg = header["config"]
        som = XPySom(
            cfg["x"],
            cfg["y"],
            cfg["input_len"],
            sigma=cfg["sigma"],
            sigmaN=cfg["sigmaN"],
            learning_rate=cfg["learning_rate"],
            learning_rateN=cfg["learning_rateN"],
            decay_function=cfg["decay_function"],
            neighborhood_function=cfg["neighborhood_function"],
            std_coeff=cfg["std_coeff"],
            topology=cfg["topology"],
            activation_distance=cfg["activation_distance"],
            activation_distance_kwargs=cfg["activation_distance_kwargs"],
            compact_support=cfg["compact_support"],
            n_parallel=cfg["n_parallel"],
            mesh=mesh,
            # absent in format-1 checkpoints written before the
            # first-class kernel config: fall back to fresh resolution
            bmu_precision=cfg.get("bmu_precision"),
            bmu_tiles=tuple(cfg["bmu_tiles"]) if cfg.get("bmu_tiles") else None,
            use_pallas=cfg.get("use_pallas"),
        )
        w = np.asarray(z["weights"])
        expect = (cfg["x"], cfg["y"], cfg["input_len"])
        if w.shape != expect:
            raise ValueError(
                f"checkpoint weights shape {w.shape} does not match its "
                f"own config {expect} — corrupt or hand-edited file"
            )
        som._weights = w
        som._random_generator.set_state(
            (
                "MT19937",
                np.asarray(z["rng_keys"], dtype=np.uint32),
                int(z["rng_meta"][0]),
                int(z["rng_meta"][1]),
                float(z["rng_gauss"][0]),
            )
        )
        # Default to 0 when the checkpoint was saved without epoch=, so the
        # documented resume recipe train(..., iter_beg=ckpt._checkpoint_epoch)
        # never sees None.
        _epoch = header.get("epoch")
        som._checkpoint_epoch = 0 if _epoch is None else int(_epoch)
    return som


def _rng_arrays(rng_states):
    """Stack MT19937 states into three arrays (keys/meta/gauss)."""
    keys = np.stack([np.asarray(s[1], dtype=np.uint32) for s in rng_states])
    meta = np.asarray([[s[2], s[3], 0] for s in rng_states], dtype=np.float64)
    gauss = np.asarray([s[4] for s in rng_states], dtype=np.float64)
    return keys, meta, gauss


def save_population_checkpoint(pop, path, *, epoch=None):
    """One portable ``.npz`` for a whole :class:`SomPopulation`: the
    stacked ``(P, X, Y, D)`` codebooks, every member's RNG state and a
    JSON header with each member's constructor config — the population
    analog of :func:`save_checkpoint`, giving long model-selection
    sweeps the same fault tolerance as single-model training
    (VERDICT r3 #8; the reference's serial per-candidate workflow,
    xpysom.py:458-594, has pickle only)."""
    if not _should_write():
        return
    path = _norm_path(path)
    header = {
        "format_version": _FORMAT_VERSION,
        "population": {
            "n_members": pop.n_members,
            # 0 = auto-sized, like the single-model n_parallel treatment;
            # a missing flag (population unpickled from before the
            # *_explicit flags) defaults to AUTO, matching _config_dict —
            # persisting the resolved value as user-explicit would drop
            # the _matrix_chunk budget on matrix-materializing paths
            "n_parallel": (
                int(pop._n_parallel)
                if getattr(pop, "_n_parallel_explicit", False)
                else 0
            ),
            "configs": [_config_dict(m) for m in pop.members],
        },
        "epoch": epoch,
    }
    keys, meta, gauss = _rng_arrays(
        [m._random_generator.get_state() for m in pop.members]
    )
    _atomic_savez(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        weights=np.ascontiguousarray(pop.weights),
        rng_keys=keys,
        rng_meta=meta,
        rng_gauss=gauss,
    )


def load_population_checkpoint(path, *, mesh=None):
    """Rebuild a :class:`SomPopulation` from a population checkpoint.
    ``mesh`` re-attaches a data-parallel mesh on the loading host (like
    :func:`load_checkpoint`, hardware is a property of the host, not the
    checkpoint)."""
    from ..models.population import SomPopulation

    with np.load(_norm_path(path)) as z:
        if "header" not in z.files or "weights" not in z.files:
            raise ValueError(
                f"{path!r} is not an xpysom checkpoint "
                f"(missing header/weights entries; found {z.files})"
            )
        header = json.loads(bytes(z["header"]).decode())
        if header["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {header['format_version']} is newer than "
                f"this library supports ({_FORMAT_VERSION})"
            )
        if "population" not in header:
            raise ValueError(
                f"{path!r} is a single-model checkpoint — use load_checkpoint"
            )
        meta_hdr = header["population"]
        cfgs = meta_hdr["configs"]
        p = int(meta_hdr["n_members"])
        if len(cfgs) != p:
            raise ValueError(
                f"corrupt population checkpoint: {len(cfgs)} member configs "
                f"for n_members={p}"
            )
        c0 = cfgs[0]
        pop = SomPopulation(
            p,
            c0["x"],
            c0["y"],
            c0["input_len"],
            sigma=[c["sigma"] for c in cfgs],
            sigmaN=[c["sigmaN"] for c in cfgs],
            learning_rate=[c["learning_rate"] for c in cfgs],
            learning_rateN=[c["learning_rateN"] for c in cfgs],
            decay_function=c0["decay_function"],
            neighborhood_function=c0["neighborhood_function"],
            std_coeff=c0["std_coeff"],
            topology=c0["topology"],
            activation_distance=c0["activation_distance"],
            activation_distance_kwargs=c0["activation_distance_kwargs"],
            compact_support=c0["compact_support"],
            n_parallel=meta_hdr.get("n_parallel", 0),
            mesh=mesh,
        )
        w = np.asarray(z["weights"])
        expect = (p, c0["x"], c0["y"], c0["input_len"])
        if w.shape != expect:
            raise ValueError(
                f"checkpoint weights shape {w.shape} does not match its "
                f"own config {expect} — corrupt or hand-edited file"
            )
        keys = np.asarray(z["rng_keys"], dtype=np.uint32)
        meta = np.asarray(z["rng_meta"])
        gauss = np.asarray(z["rng_gauss"])
        for i, m in enumerate(pop.members):
            m._weights = w[i].copy()
            # restore each member's kernel config with the same semantics
            # as single-model load_checkpoint: bmu_precision is numeric
            # and travels unconditionally (a resumed sweep must run the
            # argmin kernel the earlier epochs ran); use_pallas/bmu_tiles
            # are hardware tuning, stored only when explicit
            c = cfgs[i]
            if c.get("bmu_precision"):
                m._bmu_precision = c["bmu_precision"]
                m._bmu_precision_explicit = True
            if c.get("bmu_tiles"):
                m._bmu_tiles = tuple(c["bmu_tiles"])
                m._bmu_tiles_explicit = True
            if c.get("use_pallas") is not None:
                m._use_pallas = bool(c["use_pallas"])
                m._use_pallas_explicit = True
            m._random_generator.set_state(
                (
                    "MT19937",
                    keys[i],
                    int(meta[i][0]),
                    int(meta[i][1]),
                    float(gauss[i]),
                )
            )
        _epoch = header.get("epoch")
        pop._checkpoint_epoch = 0 if _epoch is None else int(_epoch)
    return pop
