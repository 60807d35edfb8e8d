"""The statistics pass's count kernel (``csrc/counts.cu``) on the card: its
counts equal the plain version's exactly at the UK Biobank layouts, its
CUDA-event time on words of the ``array3`` cell's shape against one read of
them, and one whole pass at UK Biobank imputed's layout, whose word rows no
block of the old pass divided.  Without a card every test here skips; run
them on the card with ``python -m pytest --noconftest
tests/test_torch_counts.py -m card -s``.  The CPU tests of the counts are
in ``test_torch_data.py``."""

import time

import pytest
import torch

from gvamp_tpu_torch import data
from gvamp_tpu_torch.ops import matvec

# (Nw, Mpad) of the loader's layouts: UK Biobank array (N 488,377) on 3
# cards, the same on 2 cards, and UK Biobank imputed (N 414,055) on 16
ARRAY3 = (30_528, 268_800)
ARRAY2_MPAD = 402_944
IMPUTED = (25_888, 527_360)
# one read of the words at the H100's HBM rate, and the kernel's target
HBM_BYTES_PER_S = 3.35e12
TARGET_SHARE = 0.85


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the count kernel runs only there")


def _words(nw: int, m: int, seed: int) -> torch.Tensor:
    """Random words: every code, missing calls a quarter of them; drawn
    in bands of rows, so that no temporary is as large as the words."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = torch.empty((nw, m), dtype=torch.int32, device="cuda")
    band = max(1, 2 ** 28 // (4 * m))
    for r in range(0, nw, band):
        words[r:r + band] = torch.randint(
            -2 ** 31, 2 ** 31 - 1, (min(band, nw - r), m), generator=gen,
            dtype=torch.int32, device="cuda")
    return words


def _na(nw: int, seed: int, share: float = 0.97) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand((4, 4 * nw), generator=gen, device="cuda")
            < share).to(torch.float32)


def _event_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _median(xs):
    return sorted(xs)[len(xs) // 2]


# (Nw, allocated width, first marker, last marker): marker slices of the
# array and imputed word rows, copied out contiguous as a mesh slab is,
# whole blocks of 1,024 markers and with a last block that the width ends
# inside, and the full widths of the 2-card array share and the imputed
# share at a few word rows
SLICES = [pytest.param(ARRAY3[0], 4096, 1024, 3072, id="array3-blocks"),
          pytest.param(ARRAY3[0], 4096, 1000, 3532, id="array3-tail"),
          pytest.param(IMPUTED[0], 4096, 1024, 3072, id="imputed-blocks"),
          pytest.param(IMPUTED[0], 4096, 4, 4092, id="imputed-tail"),
          pytest.param(96, ARRAY2_MPAD, 0, ARRAY2_MPAD, id="array2-width"),
          pytest.param(96, IMPUTED[1], 0, IMPUTED[1], id="imputed-width")]


@pytest.mark.card
@pytest.mark.parametrize("nw,m,lo,hi", SLICES)
def test_counts_equal_the_plain_version(card, nw, m, lo, hi):
    """The kernel's S_a, S_b, S_aa equal the plain version's exactly (the
    plain version run on the card, the same torch integer code as on the
    CPU), and the kernel launched once."""
    words = _words(nw, m, seed=nw + m)[:, lo:hi].contiguous()
    na = _na(nw, seed=nw)
    matvec.reset_launches()
    got = matvec.marker_counts(words, na)
    assert matvec.LAUNCHES["marker_counts"] == 1
    want = matvec.marker_counts_ref(words, na)
    assert torch.equal(got, want)
    assert int(want[1].max()) <= 16 * nw and int(want[0].min()) >= 0


@pytest.mark.card
def test_count_kernel_time_at_array3(card):
    """The kernel's CUDA-event time on random words of the ``array3`` cell's
    shape (32.8 GB) against one read of them at 3.35 TB/s, and the whole
    statistics pass (mask, counts, the f32 formula) around it."""
    nw, m = ARRAY3
    words = _words(nw, m, seed=3)
    na = _na(nw, seed=4)
    mask = matvec.na_mask_words(na)
    out = torch.zeros((3, m), dtype=torch.int32, device="cuda")
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()

    def bare():
        matvec._launch("marker_counts", lib.gvamp_marker_counts, words.device,
                       words.data_ptr(), mask.data_ptr(), out.data_ptr(), nw,
                       m)

    bound_ms = 4.0 * nw * m / HBM_BYTES_PER_S * 1e3
    bare()
    kern = _event_ms(bare, 20)
    wrapped = _event_ms(lambda: matvec.marker_counts(words, na), 10)
    nonas = float(na.sum())
    passes = _event_ms(lambda: data._marker_stats(words, na, nonas, 1.0,
                                                  torch.float32), 5)
    name = torch.cuda.get_device_name()
    k = _median(kern)
    print(f"\n{name}: marker_counts at Nw {nw} x Mpad {m} "
          f"({4 * nw * m / 1e9:.1f} GB): kernel {k:.3f} ms "
          f"(min {min(kern):.3f}, max {max(kern):.3f}), "
          f"{4 * nw * m / k / 1e6:.0f} GB/s, {100 * bound_ms / k:.1f}% of "
          f"the read's {bound_ms:.2f} ms; wrapper {_median(wrapped):.3f} ms; "
          f"whole pass {_median(passes):.3f} ms")
    assert k <= bound_ms / TARGET_SHARE


@pytest.mark.card
def test_whole_pass_at_the_imputed_layout(card):
    """One statistics pass at UK Biobank imputed's layout on 16 cards (Nw
    25,888: Nw/32 = 809, a prime; Mpad 527,360; 54.6 GB) takes well under
    a second, where the blocked pass took minutes."""
    nw, m = IMPUTED
    words = _words(nw, m, seed=16)
    na = _na(nw, seed=17)
    nonas = float(na.sum())
    data._marker_stats(words, na, nonas, 1.0, torch.float32)
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        mave, msig = data._marker_stats(words, na, nonas, 1.0, torch.float32)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    gb = 4 * nw * m / 1e9
    print(f"\n{torch.cuda.get_device_name()}: a statistics pass at Nw {nw} "
          f"x Mpad {m} ({gb:.1f} GB): {min(secs):.4f}-{max(secs):.4f} s, "
          f"{min(secs) / gb * 1e3:.3f} ms per GB")
    assert bool(torch.isfinite(mave).all()) and bool((msig > 0).all())
    assert max(secs) < 1.0
