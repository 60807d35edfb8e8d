"""State carried between the JAX package and the port, as numpy arrays.

With these a test runs one JAX step and one port step from the same state,
probe and operator and compares them, which is sharper than comparing whole
trajectories (they amplify f32 noise).  Nothing here imports JAX: the
caller converts JAX arrays with ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from gvamp_tpu_torch import linear
from gvamp_tpu_torch.data import GenoBed, container_device, words_from_numpy


def geno_from_numpy(words: np.ndarray, y_raw: np.ndarray, N: int,
                    M: int | None = None, Mt: int | None = None, S: int = 0,
                    mave=None, msig=None, standardize_phen: bool = True,
                    alpha_scale: float = 1.0, device="cuda",
                    dtype=torch.float32, mesh=None) -> GenoBed:
    """A port container from the JAX container's words uint32[Nw, Mpad],
    on the card unless ``device`` names another.  ``mave``/``msig`` given as
    arrays skip the statistics pass.  Under ``mesh`` (a
    ``dist.Mesh``, whose device ``device`` must name) the global words are
    split into the mesh's local slabs: the same words as a JAX container
    sharded over a K-device mesh, K the mesh's shard count."""
    device = container_device(device, mesh)
    if mesh is not None:
        words = mesh.split(np.ascontiguousarray(words, dtype=np.uint32)
                           .view(np.int32))
    else:
        words = words_from_numpy(words, device)
    return GenoBed.from_device_words(
        words, y_raw, N=N, M=M, Mt=Mt, S=S,
        standardize_phen=standardize_phen, alpha_scale=alpha_scale,
        dtype=dtype, mave=mave, msig=msig, mesh=mesh)


def _fields(d: dict, state_cls, device, dtype, skip=()) -> dict:
    """The fields of ``state_cls`` from arrays: ``it`` as a host int,
    floating arrays in ``dtype``, bool and integer arrays as they are."""
    out = {}
    for name in state_cls._fields:
        if name in skip:
            continue
        v = np.asarray(d[name])
        out[name] = (int(v) if name == "it" else torch.tensor(
            v, dtype=dtype if np.issubdtype(v.dtype, np.floating) else None,
            device=device))
    return out


def _generator(d: dict, gen) -> torch.Generator:
    """A new CPU generator: seeded by ``gen`` when that is an int, restored
    from ``gen``'s bytes when it is a uint8 array, or from ``d["gen"]`` (a
    port state's bytes) when ``gen`` is None."""
    from gvamp_tpu_torch import robust
    if gen is None:
        gen = d["gen"]
    if isinstance(gen, (int, np.integer)):
        return robust.make_generator(int(gen))
    g = torch.Generator(device="cpu")
    g.set_state(torch.from_numpy(np.array(gen, dtype=np.uint8)))
    return g


def state_from_numpy(d: dict, device="cuda",
                     dtype=torch.float32) -> linear.LinState:
    """``gvamp_tpu.linear.LinState`` fields (as arrays) -> port state on the
    card unless ``device`` names another, primal and dual (``*_n``) fields
    alike, the probe columns' warm starts and Gram products included
    (``mu_probe`` [Mpad, P], ``mu_probe_n`` [4, Nb, P]) and the
    cross-validation field ``cv_r2`` (-1 where ``d`` lacks it)."""
    if "cv_r2" not in d:
        d = dict(d, cv_r2=np.asarray(-1.0))
    return linear.LinState(**_fields(d, linear.LinState, device, dtype))


def state_to_numpy(state) -> dict:
    """Port state (of any engine, the multi-trait ones included) -> the
    fields of its JAX counterpart that it holds; a generator as its state
    bytes."""
    return {name: (np.asarray(v) if name == "it"
                   else v.get_state().numpy()
                   if isinstance(v, torch.Generator)
                   else v.detach().cpu().numpy())
            for name, v in zip(state._fields, state)}


def aux_from_numpy(geno: GenoBed, cfg: linear.VampConfig, bern: np.ndarray,
                   freeze=None, true_signal=None,
                   xxt_diag_base=None) -> linear.Aux:
    """The step's set-up with the given probe (e.g. JAX's make_bern_probe)
    and, where given, the dual Jacobi base (JAX's ``Aux.xxt_diag_base``)
    in place of the port's own people statistics."""
    aux = linear.make_aux(geno, cfg, freeze=freeze, true_signal=true_signal,
                          bern=np.asarray(bern))
    if xxt_diag_base is None:
        return aux
    return aux._replace(xxt_diag_base=torch.tensor(
        np.asarray(xxt_diag_base), dtype=geno.dtype, device=geno.device))


def probit_state_from_numpy(d: dict, device="cuda", dtype=torch.float32):
    """``gvamp_tpu.probit.ProbitState`` fields (as arrays) -> port state."""
    from gvamp_tpu_torch import probit
    return probit.ProbitState(**_fields(d, probit.ProbitState, device, dtype))


def robust_state_from_numpy(d: dict, device="cuda", dtype=torch.float32,
                            gen=None):
    """``gvamp_tpu.robust.RobustState`` fields (as arrays; JAX's ``key`` is
    ignored) -> port state.  Its generator is a new CPU generator, seeded
    by ``gen`` when that is an int, restored from ``gen``'s bytes when it
    is a uint8 array, or from ``d["gen"]`` (a port state's bytes) when
    ``gen`` is None."""
    from gvamp_tpu_torch import robust
    return robust.RobustState(gen=_generator(d, gen), **_fields(
        d, robust.RobustState, device, dtype, skip=("gen",)))


def multi_state_from_numpy(d: dict, device="cuda", dtype=torch.float32):
    """``gvamp_tpu.multi.MultiState`` fields (as arrays) -> port state;
    ``stopped`` stays bool."""
    from gvamp_tpu_torch import multi
    return multi.MultiState(**_fields(d, multi.MultiState, device, dtype))


def probit_multi_state_from_numpy(d: dict, device="cuda",
                                  dtype=torch.float32):
    """``gvamp_tpu.multi.ProbitMultiState`` fields (as arrays) -> port
    state."""
    from gvamp_tpu_torch import multi
    return multi.ProbitMultiState(**_fields(d, multi.ProbitMultiState,
                                            device, dtype))


def huber_multi_state_from_numpy(d: dict, device="cuda", dtype=torch.float32,
                                 gen=None):
    """``gvamp_tpu.multi.HuberMultiState`` fields (as arrays; JAX's ``key``
    is ignored) -> port state, its generator made from ``gen`` as in
    ``robust_state_from_numpy``."""
    from gvamp_tpu_torch import multi
    return multi.HuberMultiState(gen=_generator(d, gen), **_fields(
        d, multi.HuberMultiState, device, dtype, skip=("gen",)))
