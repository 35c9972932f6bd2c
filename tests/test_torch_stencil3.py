"""The port's front-stencil variants (airjax_torch.kernels.stencil3) against
airjax: `magdet_tree_plain` per variant against the Pallas `magdet_tree`
in interpret mode, and against the port's flat front
(`magdet_plain(packed=False)`). On the CPU the wrapper runs the plain
version; the kernel is compared with it on the card
(tests/test_torch_cuda.py). Every output is a bit: the tolerance is exact
equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from airjax.kernels.magdet import EXTRA, TILE, pad_for_kernel
from airjax.kernels.stencil3 import magdet_tree as jax_magdet_tree
from airjax_torch.io import synth
from airjax_torch.kernels import stencil3 as stencil3_mod
from airjax_torch.kernels.magdet import magdet_plain
from airjax_torch.kernels.stencil3 import magdet_tree, magdet_tree_plain
from torch_parity import assert_same

VARIANTS = ["tree32", "tree16", "flat16"]
# int16 extremes and equal-magnitude rows (ties pass the >= gate).
EXTREMES = [
    [-32768, -32768], [32767, 32767], [0, 0], [1, 0],
    [-32768, 0], [3, 4], [255, 255], [256, 256],
]


def _iq(n: int, seed: int, lo: int = -32768, hi: int = 32768) -> np.ndarray:
    iq = np.random.default_rng(seed).integers(lo, hi, size=(n, 2), dtype=np.int16)
    iq[:8] = EXTREMES
    return iq


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_magdet_tree(variant):
    padded, n_dom = pad_for_kernel(jnp.asarray(_iq(TILE + 901, 11)))
    det_k, cmp_k = jax_magdet_tree(padded, variant=variant, interpret=True)
    det, cmp = magdet_tree_plain(torch.as_tensor(np.array(padded)), n_dom, variant)
    assert det.dtype == torch.uint8 and cmp.dtype == torch.uint8
    assert cmp.shape[0] == padded.shape[0] - 1
    assert_same(np.asarray(det_k), det)
    assert_same(np.asarray(cmp_k), cmp[:n_dom])
    assert int(det.sum()) > 0


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", ["random", "small", "frames"])
def test_plain_matches_flat_front(variant, kind):
    """Against magdet_plain(packed=False) at a ragged length: full-range
    noise, small-range noise (ties and detections everywhere) and DF17
    traffic."""
    n = 20239
    if kind == "random":
        iq = _iq(n, 3)
    elif kind == "small":
        iq = _iq(n, 4, -2, 3)
    else:
        frame = synth.make_df17(0x7C6B30, synth.make_id_me("TREE000"))
        offsets = list(range(37, n - 240, 1999))
        iq = synth.modulate([frame] * len(offsets), offsets, n, noise_std=40.0, seed=3)
    iq_t = torch.as_tensor(iq)
    det, cmp = magdet_tree(iq_t, n - 240, variant)
    det_f, cmp_f = magdet_plain(iq_t, n - 240, packed=False)
    assert torch.equal(det, det_f) and torch.equal(cmp, cmp_f)
    if kind != "random":
        assert int(det.sum()) > 0


def test_pallas_geometry_at_the_tile_edge():
    """Frames across the TILE edge of airjax's geometry: the tree's
    cropped views reach +25 past each offset."""
    frame = synth.make_df17(0x4840D6, synth.make_id_me("EDGE000"))
    n = 2 * TILE + EXTRA
    offsets = [TILE - 240, TILE - 13, TILE - 1, TILE + 5]
    offsets = [o + 300 * i for i, o in enumerate(offsets)]
    iq = synth.modulate([frame] * 4, offsets, n, noise_std=40.0, seed=5)
    det_k, _ = jax_magdet_tree(jnp.asarray(iq), variant="tree32", interpret=True)
    for variant in VARIANTS:
        det, _ = magdet_tree_plain(torch.as_tensor(iq), 2 * TILE, variant)
        assert_same(np.asarray(det_k), det, variant)
        assert all(det[o] for o in offsets)


def test_wrapper_checks_and_counts_no_cpu_launch():
    iq = torch.as_tensor(_iq(3000, 2))
    before = stencil3_mod.launches
    for variant in VARIANTS:
        magdet_tree(iq, 2500, variant)
    assert stencil3_mod.launches == before
    with pytest.raises(ValueError):
        magdet_tree(iq, 2500, "tree8")
    with pytest.raises(ValueError):
        magdet_tree(iq, 3000 - 24, "tree16")  # the taps would reach past the block
    with pytest.raises(ValueError):
        magdet_tree(iq.to(torch.int32), 2500, "tree32")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("short", [25, 26, 28, 29, 30])
def test_plain_at_the_last_offsets_a_block_holds(variant, short):
    """n_off up to L - 25, the wrapper's limit: the plain tree gives n_off
    offsets, equal to the flat front's (it raised a size mismatch above
    L - 29 while it cropped every view to the roll-7 one, as airjax's
    padded rows allow)."""
    n = 3001
    iq_t = torch.as_tensor(_iq(n, 6, -2, 3))
    det, cmp = magdet_tree(iq_t, n - short, variant)
    det_f, cmp_f = magdet_plain(iq_t, n - short, packed=False)
    assert det.shape == (n - short,) and torch.equal(det, det_f) and torch.equal(cmp, cmp_f)
    assert int(det.sum()) > 0


@pytest.mark.parametrize("form, gate", [("front", "df17"), ("front", "preamble"), ("tree32", "df17"),
                                        ("tree16", "df17"), ("flat16", "df17")])
def test_planes_baseline_on_the_cpu_is_the_plain_version(form, gate):
    """kernels/magdet.py::magdet_planes_baseline, the first forms' wrapper:
    on a CPU tensor the plain version of its form, no launch counted; a
    stencil form refuses the preamble gate."""
    from airjax_torch.kernels import magdet as magdet_mod

    iq = torch.as_tensor(_iq(3000, 9, -2, 3))
    before = (magdet_mod.baseline_launches, magdet_mod.planes_launches, stencil3_mod.launches)
    det, cmp = magdet_mod.magdet_planes_baseline(iq, 2500, form, gate)
    det_p, cmp_p = (magdet_plain(iq, 2500, packed=False, gate=gate) if form == "front"
                    else magdet_tree_plain(iq, 2500, form))
    assert torch.equal(det, det_p) and torch.equal(cmp, cmp_p)
    assert (magdet_mod.baseline_launches, magdet_mod.planes_launches, stencil3_mod.launches) == before
    if form != "front":
        with pytest.raises(ValueError):
            magdet_mod.magdet_planes_baseline(iq, 2500, form, "preamble")
    with pytest.raises(ValueError):
        magdet_mod.magdet_planes_baseline(iq, 2500, "tree8", gate)
