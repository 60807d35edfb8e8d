"""Genotype/phenotype container of the PyTorch port: the L2 data layer.

Counterpart of ``gvamp_tpu/data.py``'s ``GenoBed`` for the main path: the
packed 2-bit design matrix (word-major int32 words, planar N layout) on one
device, the per-marker statistics, the standardised phenotype with its NA
mask, and the products ``ax``/``atx``/``axm``/``atxm``.  Scaling follows the
reference exactly as the JAX package does (``gvamp_tpu/data.py`` header):

  * A[n,m] = (g - mave_m) * nonmiss * msig_m / sqrt(N)
  * mave, msig over genotype-non-missing and phenotype-non-NA samples
  * the phenotype is scaled, not centred; NA slots are zero

Routing by dtype (the JAX package routes an f64 request to its XLA path,
``gvamp_tpu/data.py:44-63``) and by completeness (``geno_complete``, one
``atx`` pass at first use):

  * float32 runs the digit products: ``matvec.axm_i8a`` / ``atxm_i8a`` on
    complete (imputed) genotypes, where the non-missing indicator's
    contractions collapse to scalars, and ``matvec.axm_i8`` / ``atxm_i8``
    on genotypes with missing calls; the CUDA kernels on the card, their
    plain versions on the CPU;
  * float64 runs the dense plain products (true f64) and exists on the CPU
    only: float64 on CUDA raises, since no kernel takes it.

The dual (XXT) solve adds the people statistics (``ax``, its Jacobi
diagonal) and ``fn_gram_aat``, the fused dual Gram A A^T in one read of the
words (``gram_aat_i8a`` / ``gram_aat_i8``); ``fn_gram`` offers the fused
primal Gram A^T A (``gram_i8a`` / ``gram_i8``) under ``GVAMP_FUSED_GRAM=1``.
``window_fns_multi`` runs the same digit products on a word-row window of
the words, the reduced-subset solves of ``--red``.  The probit model reads
fixed covariates (``read_covariates``).

Under a marker mesh (``mesh``, a ``gvamp_tpu_torch.dist.Mesh``) ``words``
is the tuple of this process's slabs, each contiguous on its shard's
device, and ``Mpad`` is rounded to ``marker_align`` times the shard count.
The marker statistics and the transposed products run per slab and are
all-gathered; the people statistics, the completeness count and the
forward products run per slab and are all-reduced (the ``psum`` of
``gvamp_tpu/data.py:399-454, 474-490, 509-652, 877-882``); the fused
primal Gram is off and the fused dual Gram runs per slab
(``data.py:688, 742-769``).  Every marker-space vector stays replicated.
Without a mesh nothing of this runs.

The entry points put the container on the card unless the caller names
another device; without a CUDA device they raise rather than run on the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gvamp_tpu_torch import native
from gvamp_tpu_torch.io import plink
from gvamp_tpu_torch.ops import matvec
from gvamp_tpu_torch.ops.layout import PlanarLayout
from gvamp_tpu_torch.trace import span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_placement(device: torch.device, dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    if device.type == "cuda" and dtype == torch.float64:
        raise NotImplementedError(
            "float64 on CUDA: no kernel of the port takes float64 (the digit "
            "kernels are float32); run float64 on the CPU (ROADMAP.md ground "
            "rules)")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _standardize(y_raw: np.ndarray, standardize: bool):
    """(scaled y with NA -> 0, NA indicator, nonas, intercept, scale)."""
    y_raw = np.asarray(y_raw, np.float64)
    isna = np.isnan(y_raw)
    nonas = int((~isna).sum())
    if standardize and nonas > 1:
        avg = float(np.nanmean(y_raw))
        sqn = float(np.sqrt((nonas - 1) / np.nansum((y_raw - avg) ** 2)))
    else:
        avg, sqn = 0.0, 1.0
    return (np.where(isna, 0.0, y_raw * sqn), (~isna).astype(np.float64),
            nonas, avg, sqn)


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the port never moves a run to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available; pass "
            f"device='cpu' to run on the CPU")
    return device


def container_device(device, mesh=None) -> torch.device:
    """The device a container entry point builds on: ``device``, or under
    ``mesh`` the mesh's own, which ``device`` must name (a CPU mesh with
    the default ``device="cuda"`` raises rather than run on the CPU)."""
    device = torch.device(device)
    if mesh is None:
        return require_device(device)
    if device.type != mesh.device.type or (
            device.index is not None and device.index != mesh.device.index):
        raise ValueError(f"device {device} disagrees with the mesh's "
                         f"{mesh.device}: pass the device the mesh was "
                         f"built on")
    return mesh.device


def words_from_numpy(words: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32[Nw, Mpad] words -> int32 tensor with the same bits."""
    device = require_device(device)
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    if not arr.flags.writeable:  # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class BedOp(NamedTuple):
    """The operator's tensors, passed to the product functions."""

    words: torch.Tensor       # int32[Nw, Mpad] (a mesh: the local slabs)
    mave: torch.Tensor        # [Mpad]
    msig: torch.Tensor        # [Mpad]
    na_planar: torch.Tensor   # [4, Nb]
    m_mask: torch.Tensor      # [Mpad]


def _marker_stats(words, na_planar, nonas, alpha_scale, dt):
    """One pass over the packed matrix -> (mave, msig).

    Port of ``_marker_stats_kernel`` (``gvamp_tpu/data.py:84-151``).  The
    sums S_a, S_b, S_aa over the NA support are integer counts
    (``matvec.marker_counts``: the count kernel on the card, its plain
    version on the CPU and for float64), each split into hi = dt(S) and lo
    = dt(S - hi), where JAX's compensated two-sum ends (lo is 0 while the
    counts stay below 2**24).  Then mave = S_a/S_b and sumsqr = S_aa -
    mave*S_a with the lo corrections applied after the cancelling hi
    subtraction.  Under a profiler the pass is one ``marker_stats`` span
    with its ``path`` (``count_kernel`` or ``plain``), ``markers`` and
    ``word_rows``."""
    nw, m = words.shape
    path = "count_kernel" if words.device.type == "cuda" else "plain"
    with span("marker_stats", path=path, markers=m, word_rows=nw):
        counts = matvec.marker_counts(words, na_planar)
        hi = counts.to(dt)
        lo = (counts - hi.to(torch.int64)).to(dt)
        (sah, sbh, qh), (sal, sbl, ql) = hi, lo
        sa = sah + sal
        sb = sbh + sbl
        mave = torch.where(sb != 0, sa / torch.where(sb == 0, 1.0, sb), 0.0)
        sumsqr = (qh - mave * sah) + (ql - mave * sal)
        sd = torch.sqrt(sumsqr / (nonas - 1.0))
        msig = torch.where(
            sumsqr > 0,
            1.0 / torch.pow(torch.where(sumsqr <= 0, 1.0, sd), alpha_scale),
            1.0)
    return mave, msig


def _people_sumsq(words, mave, msig):
    """sum_m ((a - mave_m) msig_m)^2 b per planar slot -> f32[4, Nb]
    (``gvamp_tpu/data.py:943-965``, XLA code there, plain PyTorch here), in
    f32 for every dtype as there.  Blocks of markers cap the two decoded
    [4, Nb, block] f32 temporaries near 512 MB."""
    nw, m = words.shape
    cap = max(64, int(2 ** 29 // max(1, 2 * 16 * nw * 4)))
    block = min(512, m, ((cap + 63) // 64) * 64)
    while m % block:
        block //= 2
    mave = mave.to(torch.float32)
    msig = msig.to(torch.float32)
    acc = torch.zeros((4, 4 * nw), dtype=torch.float32, device=words.device)
    for lo in range(0, m, block):
        a, b = matvec.decode_planar_dense(words[:, lo:lo + block],
                                          torch.float32)
        v = (a - mave[lo:lo + block]) * msig[lo:lo + block] * b
        acc = acc + (v * v).sum(dim=2)
    return acc


class _Planar:
    """What the two containers share: the products by name, the planar
    vectors and the marker padding, the covariates and chromosomes.  A
    subclass has ``layout``, ``N``, ``M``, ``S``, ``Mpad``, ``dtype``,
    ``device``, ``na_planar``, ``y_planar``, ``covs``, ``bim_path``,
    ``n_offset``, ``_chroms``, ``op`` and ``fns_multi``."""

    @property
    def inv_sqrt_n(self) -> float:
        return 1.0 / float(np.sqrt(self.N))

    def fns(self):
        """(ax_fn, atx_fn): the single-vector products, (op, x[Mpad]) ->
        [4, Nb] and (op, v[4, Nb]) -> [Mpad], run at B=1 like the JAX
        package's Pallas paths (data.py:502-544)."""
        axm_fn, atxm_fn = self.fns_multi()

        def ax_fn(op, x):
            return axm_fn(op, x[:, None])[..., 0]

        def atx_fn(op, v_planar):
            return atxm_fn(op, v_planar[:, :, None])[:, 0]

        return ax_fn, atx_fn

    def ax(self, x: torch.Tensor) -> torch.Tensor:
        return self.fns()[0](self.op, x)

    def atx(self, v_planar: torch.Tensor) -> torch.Tensor:
        return self.fns()[1](self.op, v_planar)

    def axm(self, X: torch.Tensor) -> torch.Tensor:
        return self.fns_multi()[0](self.op, X)

    def atxm(self, V: torch.Tensor) -> torch.Tensor:
        return self.fns_multi()[1](self.op, V)

    # ---------------------------------------------------------------- misc

    def chromosomes(self) -> np.ndarray:
        """int32[M] chromosome of each owned marker ('X' read as 23), from
        the ``.bim`` file the container was loaded with."""
        if self._chroms is None:
            if not self.bim_path:
                raise ValueError("no .bim file given")
            self._chroms = plink.read_chromosomes(self.bim_path, self.M,
                                                  self.S)
        return self._chroms

    def read_covariates(self, path: str, n_cov: int) -> None:
        """Fixed covariates [N, C] of the probit model (reference
        data.cpp:1050)."""
        self.covs = plink.read_covariates(path, n_cov)

    @property
    def covs_np(self) -> np.ndarray:
        if self.covs is None:
            raise ValueError("no covariates loaded")
        return self.covs

    def covs_planar(self) -> torch.Tensor:
        """Covariates as planar [4, Nb, C] (zeros at padding slots)."""
        Z = self.covs_np
        return torch.as_tensor(self.layout.planarize(Z.T).transpose(1, 2, 0),
                               dtype=self.dtype, device=self.device)

    def zx(self, eff) -> torch.Tensor:
        """Covariate product Z @ eff -> planar [4, Nb] (reference
        data.cpp:1050)."""
        z = self.covs_np @ np.asarray(eff)
        return self.planarize(z)

    def filter_pheno(self) -> torch.Tensor:
        """NA-zeroed standardised phenotype, planar (reference data.cpp:1065)."""
        return self.y_planar * self.na_planar

    def planarize(self, v: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(self.layout.planarize(np.asarray(v)),
                               dtype=self.dtype, device=self.device)

    def _sharded(self, fn, in_specs, out: str, **kw):
        """``fn`` over the mesh's slabs (``dist.Mesh.shard_map``), or
        ``fn`` itself without a mesh."""
        if self.mesh is None:
            return fn
        return self.mesh.shard_map(fn, in_specs, out, **kw)

    @property
    def _n_shards(self) -> int:
        return self.mesh.n_shards if self.mesh is not None else 1

    def _gather_m(self, parts: list) -> torch.Tensor:
        """The local slabs' marker arrays as the replicated full array
        (``dist.Mesh.all_gather_m``); without a mesh its one slab."""
        return parts[0] if self.mesh is None else self.mesh.all_gather_m(parts)

    def deplanarize(self, vp: torch.Tensor) -> np.ndarray:
        """[4, Nb] -> [N'] in the original order; a sample window's
        individuals start at index 0, so that ``[: win.N]`` selects them
        as in a container of their own (``gvamp_tpu/data.py:916-920``)."""
        arr = self.layout.deplanarize(vp.detach().cpu().numpy())
        return arr[self.n_offset:] if self.n_offset else arr

    def pad_m(self, x, fill: float = 0.0) -> torch.Tensor:
        out = np.full((self.Mpad,), fill, dtype=np.float64)
        out[: self.M] = np.asarray(x)
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)

    @property
    def m_mask(self) -> torch.Tensor:
        """[Mpad]: 1 on real markers, 0 on padding."""
        return (torch.arange(self.Mpad, device=self.device) < self.M).to(
            self.dtype)

    @property
    def n_mask_planar(self) -> torch.Tensor:
        """[4, Nb]: 1 on real individuals (including phenotype-NA ones)."""
        return torch.as_tensor(self.layout.planar_to_orig() >= 0,
                               dtype=self.dtype, device=self.device)


@dataclasses.dataclass
class GenoBed(_Planar):
    """Packed .bed container + standardised operator on one device, or on
    a marker mesh (``mesh``)."""

    layout: PlanarLayout
    N: int          # individuals
    Mt: int         # total markers
    M: int          # markers owned by this container
    S: int          # global offset of the first owned marker
    Mpad: int       # padded marker count
    words: torch.Tensor       # int32[Nw, Mpad]; a mesh: the local slabs
    mave: torch.Tensor        # [Mpad]
    msig: torch.Tensor        # [Mpad]
    na_planar: torch.Tensor   # [4, Nb] phenotype non-NA indicator
    y_planar: torch.Tensor    # [4, Nb] standardised phenotype, NA slots zero
    nonas: int
    intercept: float
    scale: float
    alpha_scale: float = 1.0
    bim_path: str = ""
    dtype: torch.dtype = torch.float32
    covs: Optional[np.ndarray] = None  # [N, C] covariates (probit model)
    _complete: Optional[bool] = None   # no missing genotypes (lazy)
    _chroms: Optional[np.ndarray] = None   # from the .bim (lazy)
    n_offset: int = 0   # first individual of a sample_window view
    mesh: Optional[object] = None   # dist.Mesh of a sharded container

    @property
    def device(self) -> torch.device:
        if self.mesh is not None:
            return self.mesh.device
        return self.words.device

    # ---------------------------------------------------------------- build

    @classmethod
    def from_arrays(cls, bed_bytes: np.ndarray, y_raw: np.ndarray, N: int,
                    Mt: int | None = None, S: int = 0,
                    standardize_phen: bool = True, alpha_scale: float = 1.0,
                    dtype=torch.float32, device="cuda", bim_path: str = "",
                    word_align: int = 32, marker_align: int = 512,
                    mesh=None) -> "GenoBed":
        """From .bed rows uint8[M, mbytes] (host) onto ``device``, or onto
        the local shards of ``mesh``."""
        device = container_device(device, mesh)
        M = bed_bytes.shape[0]
        lay = PlanarLayout.create(N, word_align=word_align)
        n_shards = mesh.n_shards if mesh is not None else 1
        Mpad = _round_up(max(M, 1), marker_align * n_shards)
        words_np = native.bed_to_words(bed_bytes, N, lay.n_words, Mpad)
        if words_np is None:
            words_np = np.full((lay.n_words, Mpad), 0x55555555, dtype=np.uint32)
            words_np[:, :M] = lay.pack_words(bed_bytes).T
        if mesh is not None:
            words = mesh.split(words_np.view(np.int32))
        else:
            words = words_from_numpy(words_np, device)
        return cls.from_device_words(
            words, y_raw, N=N, M=M, Mt=Mt, S=S,
            standardize_phen=standardize_phen, alpha_scale=alpha_scale,
            dtype=dtype, bim_path=bim_path, mesh=mesh)

    @classmethod
    def from_device_words(cls, words: torch.Tensor, y_raw: np.ndarray, N: int,
                          M: int | None = None, Mt: int | None = None,
                          S: int = 0, standardize_phen: bool = True,
                          alpha_scale: float = 1.0, dtype=torch.float32,
                          bim_path: str = "", mave=None,
                          msig=None, mesh=None) -> "GenoBed":
        """From an int32[Nw, Mpad] word tensor already on its device.

        The caller pads correctly (0x55 words beyond the real markers and
        samples).  ``mave``/``msig``, when given, replace the statistics
        pass (``convert.geno_from_numpy`` uses this to separate the pass
        from the products in tests).  Under ``mesh`` the words are either
        the full tensor, which the mesh splits into its local slabs, or
        those slabs already (a tuple); Mpad must split into the mesh's
        equal shards."""
        if mesh is not None:
            if isinstance(words, torch.Tensor):
                words = mesh.split(words)
            words = tuple(words)
            if len(words) != mesh.n_local or len(
                    {tuple(g.shape) for g in words}) != 1:
                raise ValueError(f"{len(words)} slabs of shapes "
                                 f"{[list(g.shape) for g in words]}: the mesh "
                                 f"holds {mesh.n_local} equal slabs here")
            slab = words[0]
            _check_placement(mesh.device, dtype)
        else:
            slab = words
        if slab.dtype != torch.int32 or slab.ndim != 2:
            raise ValueError(f"words must be int32[Nw, Mpad], got "
                             f"{slab.dtype}{list(slab.shape)}")
        _check_placement(slab.device, dtype)
        Nw, Mpad = slab.shape
        if mesh is not None:
            Mpad *= mesh.n_shards
        if PlanarLayout.create(N).n_words > Nw:
            raise ValueError(f"{Nw} word rows cannot hold N={N} samples")
        lay = PlanarLayout(N=N, n_words=Nw)
        M = Mpad if M is None else M
        y, na, nonas, avg, sqn = _standardize(y_raw, standardize_phen)
        dev = mesh.device if mesh is not None else words.device
        obj = cls(
            layout=lay, N=N, Mt=M if Mt is None else Mt, M=M, S=S, Mpad=Mpad,
            words=words if mesh is not None else words.contiguous(),
            mave=torch.zeros((Mpad,), dtype=dtype, device=dev),
            msig=torch.zeros((Mpad,), dtype=dtype, device=dev),
            na_planar=torch.as_tensor(lay.planarize(na), dtype=dtype, device=dev),
            y_planar=torch.as_tensor(lay.planarize(y), dtype=dtype, device=dev),
            nonas=nonas, intercept=avg, scale=sqn, alpha_scale=alpha_scale,
            bim_path=bim_path, dtype=dtype, mesh=mesh)
        if mave is None:
            obj.compute_marker_statistics()
        else:
            obj.mave = torch.tensor(np.asarray(mave), dtype=dtype, device=dev)
            obj.msig = torch.tensor(np.asarray(msig), dtype=dtype, device=dev)
        return obj

    @classmethod
    def from_files(cls, bed_path: str, phen_path: str | None, N: int, Mt: int,
                   S: int = 0, M: int | None = None, dtype=torch.float32,
                   device="cuda", standardize_phen: bool = True,
                   alpha_scale: float = 1.0, bim_path: str = "",
                   word_align: int = 32, marker_align: int = 512,
                   mesh=None) -> "GenoBed":
        """From a .bed file (and a .phen, or none) onto ``device``; under
        ``mesh`` each process reads only its shards' byte ranges
        (``dist.read_bed_slabs``)."""
        device = container_device(device, mesh)
        M = Mt if M is None else M
        if phen_path:
            y, isna = plink.read_phen(phen_path)
            y = np.where(isna, np.nan, y)
            if y.shape[0] != N:
                raise ValueError(f"{phen_path}: {y.shape[0]} phenotypes, "
                                 f"expected N={N}")
        else:
            y = np.zeros(N)
        kw = dict(standardize_phen=standardize_phen, alpha_scale=alpha_scale,
                  dtype=dtype, bim_path=bim_path)
        lay = PlanarLayout.create(N, word_align=word_align)
        if mesh is not None:
            from gvamp_tpu_torch import dist
            Mpad = _round_up(max(M, 1), marker_align * mesh.n_shards)
            slabs = dist.read_bed_slabs(bed_path, N, M, S, lay.n_words, Mpad,
                                        mesh.n_shards, mesh.shards,
                                        mesh.devices)
            return cls.from_device_words(slabs, y, N=N, M=M, Mt=Mt, S=S,
                                         mesh=mesh, **kw)
        Mpad = _round_up(max(M, 1), marker_align)
        # the native reader transposes straight from the file into the
        # planar word layout
        words = native.read_bed_words(bed_path, N, M, S, lay.n_words, Mpad)
        if words is not None:
            return cls.from_device_words(words_from_numpy(words, device), y,
                                         N=N, M=M, Mt=Mt, S=S, **kw)
        bed = plink.read_bed_slab(bed_path, N, M, S)
        return cls.from_arrays(bed, y, N=N, Mt=Mt, S=S, device=device,
                               word_align=word_align,
                               marker_align=marker_align, **kw)

    def set_phen(self, y: np.ndarray, standardize: bool = False) -> None:
        """Replace the phenotype (simulation path; reference data.hpp:55).
        Simulated phenotypes are used unstandardised (sim.cpp:219-221)."""
        y = np.asarray(y, dtype=np.float64)
        if y.size != self.N:
            raise ValueError(f"set_phen: {y.size} values, expected N={self.N}")
        yf, na, self.nonas, avg, sqn = _standardize(y, standardize)
        if standardize:
            self.intercept, self.scale = avg, sqn
        self.na_planar = self.planarize(na)
        self.y_planar = self.planarize(yf)
        self.compute_marker_statistics()

    def sample_window(self, sb: int, lb: int) -> "GenoBed":
        """The individuals [4 sb, 4 (sb + lb)) as a masked view
        (``gvamp_tpu/data.py:324-361``; reference data.cpp:728-801, 852),
        the held-out and training windows of the cross-validation damping
        tuner.  The view shares the packed words: individuals outside the
        window are zeroed by the phenotype-NA mask, which every product
        applies.  The marker statistics stay those of the full data, the
        product scale becomes 1/sqrt(4 lb) (data.cpp:825-832), and the
        phenotype keeps the full data's standardisation.  A complete
        parent's window is complete, so it keeps the a-only kernels."""
        nb = self.layout.n_bytes
        n_lo, n_hi = 4 * sb, min(4 * (sb + lb), self.N)
        cols = torch.arange(nb, device=self.device)
        colmask = ((cols >= sb) & (cols < sb + lb)).to(self.dtype)[None, :]
        win = copy.copy(self)
        win.N = n_hi - n_lo
        win.n_offset = n_lo
        win.na_planar = self.na_planar * colmask
        win.y_planar = self.y_planar * colmask
        win.nonas = int(win.na_planar.sum().item())
        win._complete = self.geno_complete
        return win

    # ---------------------------------------------------------------- stats

    def marker_stats_for(self, na_planar, nonas):
        """(mave, msig) over a phenotype-NA support; under a mesh per slab,
        then all-gathered."""
        def stats(words, na):
            return _marker_stats(words, na, float(nonas),
                                 float(self.alpha_scale), self.dtype)

        mave, msig = self._sharded(stats, (None,), "m")(self.words, na_planar)
        real = torch.arange(self.Mpad, device=self.device) < self.M
        return torch.where(real, mave, 0.0), torch.where(real, msig, 0.0)

    def compute_marker_statistics(self) -> None:
        self.mave, self.msig = self.marker_stats_for(self.na_planar, self.nonas)

    def _raw_ax_once(self, w, u):
        """Unscaled, unmasked sum_m a w - b u: the ``ax`` kernel in float32,
        the dense plain product in float64."""
        if self.dtype == torch.float64:
            return self._sharded(
                lambda g, w_, u_: matvec.ax_ref(g, w_, u_, torch.float64),
                ("m", "m"), "sum")(self.words, w, u)
        return self._sharded(matvec.ax, ("m", "m"), "sum")(self.words, w, u)

    def compute_people_statistics(self):
        """Per-individual statistics for the XXT preconditioner
        (``gvamp_tpu/data.py:422-454``, reference data.cpp:558-716):
        planar (mave_p, msig_p, numb_p), each [4, Nb], msig_p =
        sqrt((n_i - 1) / (sum v^2 - n_i mean_i^2)) on non-NA slots, 0
        elsewhere."""
        # sum_m (a - mave) msig b = a @ msig - b @ (mave msig), exact since
        # a = 0 wherever b = 0; the non-missing count is a @ 0 - b @ (-1)
        sum_v = self._raw_ax_once(self.msig, self.mave * self.msig)
        numb = self._raw_ax_once(torch.zeros_like(self.msig),
                                 -torch.ones_like(self.mave))
        sumsq = self._sharded(_people_sumsq, ("m", "m"), "sum")(
            self.words, self.mave, self.msig)
        na = self.na_planar
        numb = numb * na
        mave_p = torch.where(
            numb > 0, sum_v * na / torch.where(numb == 0, 1.0, numb), 0.0)
        denom = sumsq * na - numb * mave_p ** 2
        prec = torch.where((na > 0) & (denom != 0),
                           (numb - 1) / torch.where(denom == 0, 1.0, denom),
                           0.0)
        msig_p = torch.sqrt(torch.clamp(prec, min=0.0))
        return (mave_p.to(self.dtype), msig_p.to(self.dtype),
                numb.to(self.dtype))

    # ---------------------------------------------------------------- matvec

    @property
    def op(self) -> BedOp:
        return BedOp(words=self.words, mave=self.mave, msig=self.msig,
                     na_planar=self.na_planar, m_mask=self.m_mask)

    @property
    def geno_complete(self) -> bool:
        """True when no genotype is missing among real samples x markers
        (imputed data).  One ``atx`` pass: bv counts the non-missing real
        samples per marker (exact: ``atx`` bounds N below 2**24)."""
        if self._complete is None:
            nm = self.n_mask_planar.to(torch.float32)
            real = torch.arange(self.Mpad, device=self.device) < self.M
            n = float(self.N)

            # the count of real markers with a missing call; under a mesh
            # per slab, summed over it (gvamp_tpu/data.py:474-490)
            def incomplete(g, nm_, real_):
                _, bv = matvec.atx(g, nm_)
                return (torch.where(real_, bv, n) != n).sum()

            self._complete = int(self._sharded(
                incomplete, (None, "m"), "sum")(self.words, nm, real)) == 0
        return self._complete

    def _route(self, scale: float):
        """(axm(op, X), atxm(op, V)) at ``scale``, reading ``op.words`` and
        ``op.na_planar`` as given: the routing shared by ``fns_multi`` and
        ``window_fns_multi``.  Under a mesh each kernel runs per slab: the
        forward partials are all-reduced, the transposed slabs
        all-gathered."""
        dtype = self.dtype

        if dtype == torch.float32 and self.geno_complete:
            # complete genotypes: b == 1 on real samples, so its
            # contractions collapse to the scalars colsum(U) and colsum(v)
            # (data.py:589-617, 812-816)
            axm_a = self._sharded(matvec.axm_i8a, ("m",), "sum")
            atxm_a = self._sharded(matvec.atxm_i8a, (None,), "m")

            def axm_fn(op: BedOp, X):
                W = op.msig[:, None] * X.to(dtype)
                U = op.mave[:, None] * W
                z = axm_a(op.words, W) - U.sum(dim=0)[None, None, :]
                return z * op.na_planar[:, :, None] * scale

            def atxm_fn(op: BedOp, V):
                v = V.to(dtype) * op.na_planar[:, :, None]
                av = atxm_a(op.words, v)
                sv = v.sum(dim=(0, 1))
                return ((av - op.mave[:, None] * sv[None, :])
                        * op.msig[:, None] * scale)

            return axm_fn, atxm_fn

        # both planes (data.py:619-652): the general kernels in float32, the
        # dense plain products in float64
        if dtype == torch.float64:
            def axm_raw(words, W, U):
                return matvec.axm_ref(words, W, U, dtype)

            def atxm_raw(words, V):
                return matvec.atxm_ref(words, V, dtype)
        else:
            axm_raw, atxm_raw = matvec.axm_i8, matvec.atxm_i8
        axm_raw = self._sharded(axm_raw, ("m", "m"), "sum")
        atxm_raw = self._sharded(atxm_raw, (None,), "m")

        def axm_fn(op: BedOp, X):
            W = op.msig[:, None] * X.to(dtype)
            U = op.mave[:, None] * W
            z = axm_raw(op.words, W, U)
            return z * op.na_planar[:, :, None] * scale

        def atxm_fn(op: BedOp, V):
            v = V.to(dtype) * op.na_planar[:, :, None]
            av, bv = atxm_raw(op.words, v)
            return (av - op.mave[:, None] * bv) * op.msig[:, None] * scale

        return axm_fn, atxm_fn

    def fns_multi(self):
        """(axm_fn, atxm_fn): B right-hand sides per pass over the words,
        signatures (op, X[Mpad, B]) -> z[4, Nb, B] and
        (op, V[4, Nb, B]) -> [Mpad, B]."""
        return self._route(self.inv_sqrt_n)

    def fn_gram(self):
        """The fused primal Gram ``gram_fn(op, X[Mpad, B]) -> A^T A X``
        (standardisation, NA mask and 1/N included) in one read of the
        words, or None, where the caller takes the two-pass form
        atxm(axm(.)).  The routing of ``gvamp_tpu/data.py:654-712``: off
        unless ``GVAMP_FUSED_GRAM=1``, and None

          * under ``GVAMP_NO_FUSED_GRAM=1``;
          * in float64, whose dense plain products run on the CPU;
          * under a mesh, where the forward product needs its all-reduce
            before the transposed one (``gvamp_tpu/data.py:688``);
          * when the words are not whole 16-row bands, or a block would
            take more than ``matvec.GRAM_MAX_QUADS`` marker quads (Mpad
            above 135,168 on the 132 SMs of an H100, the route's edge:
            the kernel's ring of band tiles then no longer fits the 227 KB
            of shared memory; JAX's counterpart is the 80 MB VMEM budget
            ``_GRAM_BAND_MAX_BYTES``).

        Complete genotypes run ``gram_i8a`` (b's contractions collapse to
        the scalars colsum(mave W) and colsum(z)), the others ``gram_i8``.
        The result equals the two-pass form's to f32 rounding: z is
        quantised per band here and per column there."""
        if os.environ.get("GVAMP_FUSED_GRAM", "") != "1":
            return None
        if os.environ.get("GVAMP_NO_FUSED_GRAM", "") == "1":
            return None
        if self.dtype == torch.float64 or self.mesh is not None:
            return None
        if not matvec.gram_fits(self.words):
            return None
        dtype = self.dtype
        scale2 = self.inv_sqrt_n * self.inv_sqrt_n

        if self.geno_complete:
            def gram_fn(op: BedOp, X):
                W = op.msig[:, None] * X.to(op.msig.dtype)
                cu = (op.mave[:, None] * W).sum(dim=0)
                av, sv = matvec.gram_i8a(op.words, W, op.na_planar, cu)
                return ((av.to(dtype) - op.mave[:, None] * sv.to(dtype)[None, :])
                        * op.msig[:, None] * scale2)
        else:
            def gram_fn(op: BedOp, X):
                W = op.msig[:, None] * X.to(op.msig.dtype)
                av, bv = matvec.gram_i8(op.words, W, op.mave[:, None] * W,
                                        op.na_planar)
                return ((av.to(dtype) - op.mave[:, None] * bv.to(dtype))
                        * op.msig[:, None] * scale2)

        return gram_fn

    def fn_gram_aat(self):
        """The fused dual Gram ``gram_aat_fn(op, Up[4, Nb, B]) -> A A^T Up``
        (standardisation, NA mask and 1/N included) in one read of the
        words, or None, where the caller takes the two-pass form
        axm(atxm(.)).  The routing of ``gvamp_tpu/data.py:714-769``: on by
        default, and None

          * under ``GVAMP_NO_FUSED_GRAM=1``;
          * in float64, whose dense plain products run on the CPU;
          * for N above 13,152 (``matvec.GRAM_AAT_MAX_NW`` word rows, the
            route's edge, whose stripe cache fits the 227 KB of shared
            memory ``matvec.GRAM_AAT_SMEM_BUDGET``; JAX's counterpart is the
            80 MB VMEM budget ``_GRAM_BAND_MAX_BYTES``) or where Mpad is not
            a whole number of ``matvec.GRAM_AAT_STRIPE``-marker stripes.

        Complete genotypes run ``gram_aat_i8a``, the others
        ``gram_aat_i8``.  The dual Gram is additive over marker shards, so
        under a mesh it runs per slab (the fit checked on the slab's width)
        and one all-reduce sums the slabs' results."""
        if os.environ.get("GVAMP_NO_FUSED_GRAM", "") == "1":
            return None
        if self.dtype == torch.float64:
            return None
        if not matvec.gram_aat_fits(self.layout.n_words,
                                    self.Mpad // self._n_shards):
            return None
        dtype = self.dtype
        scale2 = self.inv_sqrt_n * self.inv_sqrt_n
        aat = self._sharded(matvec.gram_aat_i8a if self.geno_complete
                            else matvec.gram_aat_i8, (None, "m", "m"), "sum")

        def gram_aat_fn(op: BedOp, Up):
            v = Up.to(op.msig.dtype) * op.na_planar[:, :, None]
            z = aat(op.words, v, op.mave, torch.square(op.msig))
            return z.to(dtype) * op.na_planar[:, :, None] * scale2

        return gram_aat_fn

    def window_fns_multi(self, lbw: int):
        """(axm_w, atxm_w) over the word-row window [sbw, sbw + lbw), the
        reduced-subset solves of ``--red`` (``gvamp_tpu/data.py:771-853``,
        reference data.cpp:728-801): each pass reads ``lbw / n_words`` of
        the packed matrix.  ``sbw`` is a host int, a multiple of 32, so the
        window ``words[sbw:sbw + lbw]`` is a contiguous, 16-byte-aligned
        row view that the kernels take as it is.  The marker statistics
        stay those of the full data and the scale becomes 1/sqrt(16 lbw)
        (data.cpp:825-832).  The routing of ``fns_multi``, never the fused
        Gram.

        Signatures: axm_w(op, X[Mpad, B], sbw) -> z[4, 4 lbw, B] and
        atxm_w(op, V[4, 4 lbw, B], sbw) -> [Mpad, B]."""
        lbw = int(lbw)
        axm_fn, atxm_fn = self._route(1.0 / float(np.sqrt(16 * lbw)))

        nw = self.layout.n_words

        def window(op: BedOp, sbw: int) -> BedOp:
            if sbw % 32 or not 0 <= sbw <= nw - lbw:
                raise ValueError(f"window start {sbw}: must be a multiple of "
                                 f"32 in [0, {nw - lbw}]")
            words = (tuple(g[sbw:sbw + lbw] for g in op.words)
                     if self.mesh is not None else op.words[sbw:sbw + lbw])
            return op._replace(words=words,
                               na_planar=op.na_planar[:, 4 * sbw:4 * (sbw + lbw)])

        def axm_w(op: BedOp, X, sbw: int):
            return axm_fn(window(op, sbw), X)

        def atxm_w(op: BedOp, V, sbw: int):
            return atxm_fn(window(op, sbw), V)

        return axm_w, atxm_w


class DenseOp(NamedTuple):
    """The dense operator's tensors, passed to the product functions."""

    X: torch.Tensor           # [Mpad, N], original sample order
    mave: torch.Tensor        # [Mpad]
    msig: torch.Tensor        # [Mpad]
    na_planar: torch.Tensor   # [4, Nb]
    m_mask: torch.Tensor      # [Mpad]


# float64 elements per chunk of the dense statistics pass: 2**25 (256 MB,
# 4,096 probes at N = 8,192) per temporary
_DENSE_CHUNK = 2 ** 25


def _dense_stats(rows, na, nonas: int, alpha_scale: float, M: int,
                 Mpad: int, dtype):
    """(mave, msig) of a dense matrix in float64 on its device
    (``gvamp_tpu/data.py:1025-1033, 1177-1190``): ``rows(lo, hi)`` gives the
    float64 rows [lo, hi); ``na`` is the float64 phenotype non-NA indicator
    [N].  mave = sum x na / sum na, sumsqr = sum ((x - mave) na)^2,
    msig = (1 / sd)^alpha_scale with sd = sqrt(sumsqr / (nonas - 1)), 1
    where sumsqr is 0, and both 0 on the padding rows.  The counts are
    floored at 1 as ``GenoDense.set_phen`` floors them; with 2 or more
    phenotypes, as every run has, JAX's two formulas agree."""
    step = max(1, _DENSE_CHUNK // max(1, na.numel()))
    cnt = torch.clamp(na.sum(), min=1.0)
    mave = torch.zeros((Mpad,), dtype=torch.float64, device=na.device)
    msig = torch.zeros((Mpad,), dtype=torch.float64, device=na.device)
    for lo in range(0, M, step):
        hi = min(M, lo + step)
        x = rows(lo, hi)
        mv = (x * na).sum(dim=1) / cnt
        sumsqr = torch.square((x - mv[:, None]) * na).sum(dim=1)
        sd = torch.sqrt(sumsqr / max(nonas - 1.0, 1.0))
        mave[lo:hi] = mv
        msig[lo:hi] = torch.where(
            sumsqr != 0,
            1.0 / torch.pow(torch.where(sd == 0, 1.0, sd), alpha_scale), 1.0)
    return mave.to(dtype), msig.to(dtype)


@dataclasses.dataclass
class GenoDense(_Planar):
    """Dense design-matrix container: the methylation path of
    ``--type-data meth`` (``gvamp_tpu/data.py:967-1218``, reference
    data.cpp:241-278, 487-541, 1013-1045).

    X is [Mpad, N] on the device (float32; float64 on the CPU only) in the
    original sample order; N-vectors cross into the same planar [4, Nb]
    interface as ``GenoBed``'s through the layout's permutation, so every
    engine runs on it unchanged.  The products are ``torch.matmul`` with
    the centring, scaling and planar scatter of the JAX package's plain XLA
    products; no Pallas kernel computes them there, and TF32 stays off for
    them.  The marker statistics are computed on the device in float64.
    The options that need the packed operator (the p-values, the dual
    solve's people statistics, ``--red``'s windows, cross-validation's
    sample windows, the multi-trait binder) raise ``NotImplementedError``
    naming the option, where the JAX package fails with an
    ``AttributeError``.

    Under a marker mesh X is the tuple of this process's row slabs
    [Mpad / K, N] (JAX shards its rows ``P("m", None)``,
    ``gvamp_tpu/data.py:1035``), Mpad is rounded to ``marker_align`` times
    K, the products run ``torch.matmul`` per slab with the mesh's
    all-reduce / all-gather, and the statistics run per slab and are
    all-gathered."""

    layout: PlanarLayout
    N: int
    Mt: int
    M: int
    S: int
    Mpad: int
    X: torch.Tensor           # [Mpad, N]
    mave: torch.Tensor
    msig: torch.Tensor
    na_planar: torch.Tensor
    y_planar: torch.Tensor
    nonas: int
    intercept: float
    scale: float
    alpha_scale: float = 1.0
    bim_path: str = ""
    dtype: torch.dtype = torch.float32
    covs: Optional[np.ndarray] = None
    _chroms: Optional[np.ndarray] = None
    n_offset: int = 0
    mesh: Optional[object] = None   # dist.Mesh of a sharded container

    @property
    def device(self) -> torch.device:
        if self.mesh is not None:
            return self.mesh.device
        return self.X.device

    # ---------------------------------------------------------------- build

    @classmethod
    def _build(cls, X, rows, y_raw, N: int, M: int, Mt, S: int,
               standardize_phen: bool, alpha_scale: float,
               bim_path: str, mesh=None) -> "GenoDense":
        lay = PlanarLayout.create(N, word_align=8)
        y, na, nonas, avg, sqn = _standardize(y_raw, standardize_phen)
        x0 = X[0] if mesh is not None else X
        dtype = x0.dtype
        dev = mesh.device if mesh is not None else x0.device
        Mpad = x0.shape[0] * (mesh.n_shards if mesh is not None else 1)
        obj = cls(
            layout=lay, N=N, Mt=M if Mt is None else Mt, M=M, S=S, Mpad=Mpad,
            X=X, mave=None, msig=None,
            na_planar=torch.as_tensor(lay.planarize(na), dtype=dtype,
                                      device=dev),
            y_planar=torch.as_tensor(lay.planarize(y), dtype=dtype, device=dev),
            nonas=nonas, intercept=avg, scale=sqn, alpha_scale=alpha_scale,
            bim_path=bim_path, dtype=dtype, mesh=mesh)
        obj._set_stats(rows, na)
        return obj

    def _set_stats(self, rows, na: np.ndarray) -> None:
        """mave / msig over the phenotype-NA support ``na`` [N]; ``rows(lo,
        hi)`` gives the float64 rows [lo, hi) of the real markers; under a
        mesh per slab (its real rows), then all-gathered."""
        dev = self.device
        na_t = torch.as_tensor(na, dtype=torch.float64, device=dev)
        args = (na_t, self.nonas, float(self.alpha_scale))
        w = self.Mpad // self._n_shards
        parts = []
        for s in self._local_slabs():
            c0 = s * w
            m_real = max(0, min(self.M, c0 + w) - c0)
            parts.append(_dense_stats(
                lambda lo, hi, c0=c0: rows(c0 + lo, c0 + hi).to(dev), *args,
                m_real, w, self.dtype))
        self.mave = self._gather_m([p[0] for p in parts])
        self.msig = self._gather_m([p[1] for p in parts])

    def _local_slabs(self) -> dict:
        """{shard: X slab} of this process; shard 0, all of X, without a
        mesh."""
        if self.mesh is None:
            return {0: self.X}
        return dict(zip(self.mesh.shards, self.X))

    @classmethod
    def from_arrays(cls, X: np.ndarray, y_raw: np.ndarray, N: int,
                    Mt: int | None = None, S: int = 0,
                    standardize_phen: bool = True, alpha_scale: float = 1.0,
                    dtype=torch.float32, device="cuda", bim_path: str = "",
                    marker_align: int = 8, mesh=None) -> "GenoDense":
        """From a host matrix [M, N] (float64) onto ``device``, or onto the
        local slabs of ``mesh``; the statistics come from its float64
        values, as the JAX package's numpy pass computes them, before X is
        stored in ``dtype``."""
        device = container_device(device, mesh)
        X = np.asarray(X)
        if X.shape[1] != N:
            raise ValueError(f"X has {X.shape[1]} samples, expected N={N}")
        M = X.shape[0]
        n_shards = mesh.n_shards if mesh is not None else 1
        Mpad = _round_up(max(M, 1), marker_align * n_shards)
        step = max(1, _DENSE_CHUNK // max(1, N))

        def rows(lo, hi):
            return torch.as_tensor(X[lo:hi], dtype=torch.float64)

        def fill(Xd, c0):
            # the real rows [c0, c0 + len(Xd)) of M, in chunks
            for lo in range(c0, min(M, c0 + Xd.shape[0]), step):
                hi = min(M, c0 + Xd.shape[0], lo + step)
                Xd[lo - c0:hi - c0] = rows(lo, hi).to(Xd.device, dtype)
            return Xd

        _check_placement(device, dtype)
        if mesh is None:
            Xs = fill(torch.zeros((Mpad, N), dtype=dtype, device=device), 0)
        else:
            Xs = tuple(fill(torch.zeros((c1 - c0, N), dtype=dtype, device=d),
                            c0)
                       for (c0, c1), d in zip(mesh.cols(Mpad), mesh.devices))
        return cls._build(Xs, rows, y_raw, N, M, Mt, S, standardize_phen,
                          alpha_scale, bim_path, mesh=mesh)

    @classmethod
    def from_device(cls, X: torch.Tensor, y_raw: np.ndarray, N: int,
                    M: int | None = None, Mt: int | None = None, S: int = 0,
                    standardize_phen: bool = True, alpha_scale: float = 1.0,
                    bim_path: str = "", mesh=None) -> "GenoDense":
        """From a matrix [Mpad, N] already on its device, in its dtype,
        with M real rows (default all) and zero rows beyond them: no host
        copy of X is made.  Under ``mesh`` the mesh takes its slabs of X's
        rows (Mpad must split into its equal shards)."""
        if X.ndim != 2 or X.shape[1] != N:
            raise ValueError(f"X must be [Mpad, N={N}], got {list(X.shape)}")
        _check_placement(X.device, X.dtype)
        M = X.shape[0] if M is None else M

        def rows(lo, hi):
            return X[lo:hi].to(torch.float64)

        Xs = mesh.split(X, dim=0) if mesh is not None else X.contiguous()
        return cls._build(Xs, rows, y_raw, N, M, Mt, S, standardize_phen,
                          alpha_scale, bim_path, mesh=mesh)

    @classmethod
    def from_files(cls, meth_path: str, phen_path: str | None, N: int,
                   Mt: int, S: int = 0, M: int | None = None,
                   dtype=torch.float32, device="cuda",
                   standardize_phen: bool = True, alpha_scale: float = 1.0,
                   bim_path: str = "", mesh=None) -> "GenoDense":
        """From a raw-double methylation file (reference
        read_methylation_data, data.cpp:241-278) and a .phen, or none; only
        phenotype NAs are supported, as there (data.cpp:498); every process
        of a mesh reads the whole matrix, as the JAX package's do, and
        keeps its slabs."""
        M = Mt if M is None else M
        X = plink.read_meth_slab(meth_path, N, M, S)
        if phen_path:
            y, isna = plink.read_phen(phen_path)
            y = np.where(isna, np.nan, y)
            if y.shape[0] != N:
                raise ValueError(f"{phen_path}: {y.shape[0]} phenotypes, "
                                 f"expected N={N}")
        else:
            y = np.zeros(N)
        return cls.from_arrays(X, y, N=N, Mt=Mt, S=S,
                               standardize_phen=standardize_phen,
                               alpha_scale=alpha_scale, dtype=dtype,
                               device=device, bim_path=bim_path, mesh=mesh)

    def set_phen(self, y: np.ndarray, standardize: bool = False) -> None:
        """Replace the phenotype; the marker statistics follow its NA mask
        and are recomputed from the stored X (``gvamp_tpu/data.py:
        1166-1190``)."""
        y = np.asarray(y, dtype=np.float64)
        if y.size != self.N:
            raise ValueError(f"set_phen: {y.size} values, expected N={self.N}")
        yf, na, self.nonas, avg, sqn = _standardize(y, standardize)
        if standardize:
            self.intercept, self.scale = avg, sqn
        self.na_planar = self.planarize(na)
        self.y_planar = self.planarize(yf)
        w = self.Mpad // self._n_shards
        slab_of = self._local_slabs()

        def rows(lo, hi):   # within one local slab
            return slab_of[lo // w][lo % w:lo % w + hi - lo].to(torch.float64)

        self._set_stats(rows, na)

    # ---------------------------------------------------------------- matvec

    @property
    def op(self) -> DenseOp:
        return DenseOp(X=self.X, mave=self.mave, msig=self.msig,
                       na_planar=self.na_planar, m_mask=self.m_mask)

    def fns_multi(self):
        """(axm_fn, atxm_fn), B right-hand sides per product
        (``gvamp_tpu/data.py:1103-1121``): z = X^T (msig W) - colsum(mave
        msig W), scattered to the planar slots, NA-masked and scaled by
        1/sqrt(N); its transpose gathers the planar V back to the sample
        order first."""
        from gvamp_tpu_torch.ops.pvals import _ieee_f32
        dtype, scale = self.dtype, self.inv_sqrt_n
        idx = torch.as_tensor(self.layout.orig_to_planar(), device=self.device)
        nb4 = 4 * self.layout.n_bytes
        xtw = self._sharded(lambda X, W: X.T @ W, ("m",), "sum", m_axis=0)
        xv = self._sharded(lambda X, v: X @ v, (None,), "m", m_axis=0)

        def axm_fn(op: DenseOp, W):
            W = op.msig[:, None] * W.to(dtype)
            with _ieee_f32():
                Z = xtw(op.X, W) - (op.mave[:, None] * W).sum(dim=0)
            zp = torch.zeros((nb4, Z.shape[1]), dtype=dtype, device=Z.device)
            zp[idx] = Z
            return (zp.reshape(4, nb4 // 4, Z.shape[1])
                    * op.na_planar[:, :, None] * scale)

        def atxm_fn(op: DenseOp, V):
            v = (V.to(dtype) * op.na_planar[:, :, None]).reshape(nb4, -1)[idx]
            with _ieee_f32():
                av = xv(op.X, v)
            return ((av - op.mave[:, None] * v.sum(dim=0))
                    * op.msig[:, None] * scale)

        return axm_fn, atxm_fn

    def fn_gram(self):
        """None: the dense Gram takes the two-pass form, as in JAX."""
        return None

    def fn_gram_aat(self):
        """None: the dense dual Gram takes the two-pass form, as in JAX."""
        return None

    # ------------------------------------- the packed operator's own options

    def _refuse(self, what: str):
        raise NotImplementedError(
            f"{what} needs the packed .bed operator: dense (--type-data meth) "
            f"data does not run it, as in the JAX package (whose GenoDense "
            f"has no such member)")

    @property
    def words(self):
        self._refuse("the LOO / LOCO p-values (--store-pvals, --run-mode "
                     "pvals-calc)")

    def compute_people_statistics(self):
        self._refuse("the dual solve's people statistics "
                     "(--use-XXT-denoiser 1)")

    def window_fns_multi(self, lbw: int):
        self._refuse("the reduced-subset windows (--red 1)")

    def sample_window(self, sb: int, lb: int):
        self._refuse("the cross-validation sample windows (--use-cross-val 1)")

    def marker_stats_for(self, na_planar, nonas):
        self._refuse("the multi-trait binder (several --phen-files)")
