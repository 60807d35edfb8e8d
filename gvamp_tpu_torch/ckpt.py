"""Full-state checkpoints and run-end scalar histories of the port.

Port of ``gvamp_tpu/ckpt.py:76-184``.  A checkpoint is one ``.npz``: an
``f_<field>`` array per state field and a ``_meta`` JSON with ``fields``,
``it``, ``model`` and the engine's ``cfg``.  The Huber state's CPU
generator is stored as its ``get_state()`` bytes and listed under
``gen_fields`` (a key of the port; JAX's typed PRNG keys are listed under
``key_fields``).  ``load_state`` reads the port's own checkpoints and the
linear and probit ones the JAX package writes, with SLQ traces or probe
columns, and those from before the SLQ traces; a linear checkpoint without
the cross-validation field ``cv_r2`` (the port's before it ran the tuner)
resumes with -1, a fresh state's value.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gvamp_tpu_torch.io import vecio

# CG warm-start fields added to the JAX states after early checkpoints
# were written: a checkpoint without them resumes with zeros (a cold warm
# start, which the engines' guards detect), as gvamp_tpu/ckpt.py:121-171;
# and cv_r2, which the port's checkpoints lacked before it ran the
# cross-validation tuner, with -1
_WARM_START_FIELDS = {"gmu", "gmu_n", "mu_cg", "mu_probe", "mu_probe_n",
                      "tau_gmu", "mu_prevb", "gmu_prev", "cv_r2"}


def save_state(path: str, state, **extra) -> None:
    """Full state -> npz (every field plus ``extra`` in the metadata); a
    ``torch.Generator`` field is stored as its state bytes."""
    arrs, gen_fields = {}, []
    for name, v in zip(state._fields, state):
        if isinstance(v, torch.Generator):
            arrs[f"f_{name}"] = v.get_state().numpy()
            gen_fields.append(name)
        elif isinstance(v, torch.Tensor):
            arrs[f"f_{name}"] = v.detach().cpu().numpy()
        else:
            arrs[f"f_{name}"] = np.asarray(v)
    arrs["_meta"] = np.frombuffer(
        json.dumps({"fields": list(state._fields), "gen_fields": gen_fields,
                    **extra}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrs)


def read_meta(path: str) -> dict:
    """Checkpoint metadata only (the state arrays are not read)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(bytes(z["_meta"]).decode())


def _check_resumable(path: str, meta: dict) -> None:
    """Raise ValueError on the checkpoints the port cannot continue."""
    if meta.get("key_fields"):
        raise ValueError(
            f"checkpoint {path} holds JAX PRNG keys {meta['key_fields']} (a "
            f"Huber run of the JAX package): a threefry key cannot be "
            f"continued by a torch generator")


def _fill_warm_start(vals: dict, missing: list, meta: dict) -> None:
    """Zero-fill the warm-start fields a checkpoint lacks (the shapes of
    ``gvamp_tpu/ckpt.py:127-171``; the probe columns follow the
    checkpoint's own cfg, where a cfg without ``use_slq`` predates the SLQ
    traces and so ran the probe path)."""
    x1 = vals["x1"]
    if "tau_gmu" in missing:  # zero = stale: the first solve re-mults
        vals["tau_gmu"] = np.zeros(x1.shape[1:2] if x1.ndim == 2 else (),
                                   x1.dtype)
    if "mu_cg" in missing:
        vals["mu_cg"] = np.zeros_like(x1)
    if "mu_probe" in missing:
        c = meta.get("cfg", {})
        slq_on = bool(c.get("use_slq", False)) and not bool(c.get("red", False))
        n_probes = 0 if slq_on else int(c.get("n_probes", 1))
        n_cols = n_probes * (x1.shape[1] if x1.ndim == 2 else 1)
        vals["mu_probe"] = np.zeros((x1.shape[0], n_cols), x1.dtype)
    p = vals["mu_probe"]
    if "mu_probe_n" in missing:
        mun = vals["mu_cg_n"]
        vals["mu_probe_n"] = np.zeros(mun.shape + (p.shape[1],), mun.dtype)
    if "gmu" in missing:
        mu = vals["mu_cg"]
        ncols = (mu.shape[1] if mu.ndim == 2 else 1) + p.shape[1]
        vals["gmu"] = np.zeros((mu.shape[0], ncols), p.dtype)
    if "gmu_n" in missing:
        mun = vals["mu_cg_n"]
        vals["gmu_n"] = np.zeros(mun.shape + (1 + p.shape[1],), mun.dtype)
    for f in ("mu_prevb", "gmu_prev"):
        # zeros disarm the secant extrapolation until two fresh exits exist
        if f in missing:
            vals[f] = np.zeros_like(vals["gmu"])
    if "cv_r2" in missing:  # no held-out R2 accepted yet
        vals["cv_r2"] = np.asarray(-1.0, x1.dtype)


def load_state(path: str, state_cls, device="cuda", dtype=None,
               mpad: int | None = None):
    """npz -> (state_cls instance on ``device``, metadata).  Floating
    fields take ``dtype`` where given; ``it`` becomes a host int; a
    ``gen_fields`` entry becomes a new CPU generator restored from its
    bytes.  The warm-start fields a checkpoint lacks are zero-filled, and
    a missing ``cv_r2`` is -1.  Raises ValueError on a JAX Huber checkpoint
    (its PRNG key) and, with ``mpad`` given, on a checkpoint whose marker
    vectors have another padded length: one written under another shard
    count, whose Mpad differs (the JAX package resumes such a state into
    mismatched shapes)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        _check_resumable(path, meta)
        vals = {name: z[f"f_{name}"] for name in meta["fields"]}
    if mpad is not None and vals["x1"].shape[0] != mpad:
        raise ValueError(
            f"checkpoint {path} holds marker vectors of Mpad="
            f"{vals['x1'].shape[0]}; this run pads the markers to Mpad={mpad} "
            f"(Mpad is rounded to 512 times the shard count): resume with "
            f"the --devices / --n-processes that wrote it")
    gen_fields = set(meta.get("gen_fields", []))
    unknown = set(vals) - set(state_cls._fields)
    if unknown:
        raise KeyError(f"checkpoint {path} holds fields {sorted(unknown)} "
                       f"that {state_cls.__name__} lacks")
    missing = [f for f in state_cls._fields if f not in vals]
    if missing:
        if set(missing) - _WARM_START_FIELDS:
            raise KeyError(f"checkpoint {path} lacks state fields {missing}")
        _fill_warm_start(vals, missing, meta)
    out = {}
    for name in state_cls._fields:
        v = vals[name]
        if name == "it":
            out[name] = int(v)
        elif name in gen_fields:
            gen = torch.Generator(device="cpu")
            gen.set_state(torch.from_numpy(np.array(v, dtype=np.uint8)))
            out[name] = gen
        else:
            t = torch.from_numpy(np.array(v))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            out[name] = t.to(device)
    return state_cls(**out), meta


def write_scalar_history(prefix: str, history) -> None:
    """gam1s/gam2s CSVs at run end, + R2trains when the engine records it
    (vamp.cpp:778-794)."""
    vecio.write_txt(prefix + "_gam1s.csv", np.array([h["gam1"] for h in history]))
    vecio.write_txt(prefix + "_gam2s.csv", np.array([h["gam2"] for h in history]))
    if "R2_train_1" in history[0]:
        r2s = []
        for h in history:  # err_measures pushes R2 after each half-step
            r2s += [float(h["R2_train_1"]), float(h["R2_train_2"])]
        vecio.write_txt(prefix + "_R2trains.csv", np.array(r2s))
