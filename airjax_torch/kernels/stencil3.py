"""Front-stencil variants: the DF17 gate and the PPM compares through
another formulation of the stencil, in the planes contract of
`magdet(..., packed=False)`.

The port of airjax/kernels/stencil3.py (Pallas): `magdet_tree` (:203-250,
the pallas_call at :223) with its bodies `_tree_kernel_i32` (tree32),
`_tree_kernel_i16` (tree16) and `_flat_kernel_i16` (flat16) becomes the
forms kTree32, kTree16 and kFlat16 of csrc/planes.cu, on csrc/front.cu's
register-window design (a thread owns 32 offsets and runs the variant's
formulation over its window in registers). The first port,
csrc/magdet.cu::magdet_stencil_kernel, stays as their A/B baseline
(kernels/magdet.py::magdet_planes_baseline). The shift-sharing tree
(`_tree_det_cmp`, :105-145) rests on min/max being idempotent: for shift
sets B and C, reducing over B + C equals reducing over C the reductions
over B, so the 26 taps decompose into 16 shifts and 14 min/max. tree16
and flat16 run on v = mag - 32768, an order-preserving int16 (mag <=
46341). The variants serve a same-run A/B against the front's own form
(chip_smoke.py phase 5; airjax's tools/bench_stencil3.py); the decode
paths keep csrc/front.cu.

`magdet_tree` launches the kernel for a CUDA tensor and runs
`magdet_tree_plain` for a CPU tensor. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from airjax_torch._dispatch import use_kernel
from airjax_torch.dsp.demod import detect
from airjax_torch.dsp.magnitude import magnitude_u16
from airjax_torch.kernels import magdet as magdet_mod
from airjax_torch.kernels.magdet import check_iq

launches = 0
VARIANTS = ("tree32", "tree16", "flat16")  # forms of csrc/planes.cu (magdet.FORMS)


def _sh(x: torch.Tensor, s: int) -> torch.Tensor:
    """Shift by s: out[i] = x[i + s], s samples shorter."""
    return x[s:]


def _crop(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Truncate every view to the shortest among them."""
    n = min(x.shape[0] for x in xs)
    return tuple(x[:n] for x in xs)


def _tree_det(m: torch.Tensor, n_off: int) -> torch.Tensor:
    """airjax's _tree_det_cmp gate on 1-D views: (L,) -> (n_off,) bool."""
    mn, mx = torch.minimum, torch.maximum
    # Each op crops its own operands. airjax crops all four first views to
    # the roll-7 one, which its EXTRA rows absorb; on a 1-D block that
    # would leave fewer than n_off offsets for n_off > L - 29.

    # Preamble highs {0,2,7,9} = {0,2} + {0,7}
    a2min = mn(*_crop(m, _sh(m, 2)))
    hmin = mn(*_crop(a2min, _sh(a2min, 7)))

    # Preamble lows: ({0,2} + {3,10,12} + {0,1}) u ({1} + {0,7})
    a2max = mx(*_crop(m, _sh(m, 2)))
    s3, s10, s12 = _crop(_sh(a2max, 3), _sh(a2max, 10), _sh(a2max, 12))
    bmax = mx(s3, mx(s10, s12))
    c = mx(*_crop(bmax, _sh(bmax, 1)))
    e = mx(*_crop(m, _sh(m, 7)))
    lmax = mx(*_crop(c, _sh(e, 1)))

    # DF17 highs 16 + (({0,3} + {0,5}) u {7}); lows 17 + (same u {1})
    gmin = mn(*_crop(m, _sh(m, 3)))
    gmax = mx(*_crop(m, _sh(m, 3)))
    g2min = mn(*_crop(gmin, _sh(gmin, 5)))
    g2max = mx(*_crop(gmax, _sh(gmax, 5)))
    dmin = mn(*_crop(_sh(g2min, 16), _sh(m, 23)))
    dmax = mx(*_crop(_sh(g2max, 17), _sh(m, 18)))

    hmin, lmax, dmin, dmax = (x[:n_off] for x in (hmin, lmax, dmin, dmax))
    return (hmin >= lmax) & (dmin >= dmax)


def magdet_tree_plain(
    iq: torch.Tensor, n_off: int, variant: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the variant's formulation on int32 (tree32) or
    biased int16 magnitudes (tree16, flat16) -> det (n_off,) uint8,
    cmp (L-1,) uint8."""
    mags = magnitude_u16(iq)
    m = mags if variant == "tree32" else (mags - 32768).to(torch.int16)
    det = detect(m, n_off) if variant == "flat16" else _tree_det(m, n_off)
    return det.to(torch.uint8), (m[:-1] > m[1:]).to(torch.uint8)


def magdet_tree(
    iq: torch.Tensor, n_off: int, variant: str = "tree16"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(L, 2) int16 IQ -> (det (n_off,) uint8, cmp (L-1,) uint8) through
    stencil `variant` (tree32, tree16 or flat16); needs L >= n_off + 25."""
    check_iq(iq, n_off)
    if variant not in VARIANTS:
        raise ValueError(f"variant: expected one of {sorted(VARIANTS)}, got {variant!r}")
    if use_kernel(iq):
        return _tree_cuda(iq, n_off, variant)
    return magdet_tree_plain(iq, n_off, variant)


def _tree_cuda(
    iq: torch.Tensor, n_off: int, variant: str
) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    planes = magdet_mod._planes_cuda(iq, n_off, variant, "df17")
    launches += 1
    return planes
