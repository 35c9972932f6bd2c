"""Shared helpers for the airjax_torch tests: exact comparison of an airjax
result with the port's, and the fixture that gates tests on a CUDA card.

Inputs are made with numpy from a seed and handed to both packages; every
output is an integer or a bit, so the tolerance is exact equality.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum

import numpy as np
import pytest
import torch


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(expected, got, name: str = "") -> None:
    """Exact equality of one array; integer arrays compare by value and
    bit pattern (the port holds uint32 words as int32)."""
    a, b = as_numpy(expected), as_numpy(got)
    assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
    if a.dtype == np.uint32 and b.dtype == np.int32:
        b = b.view(np.uint32)
    if a.dtype == np.bool_ or b.dtype == np.bool_:
        assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same_dict(expected: dict, got: dict) -> None:
    """Key by key over the whole dict, dtypes included (a uint32 array of
    airjax's is held as int32 by the port)."""
    assert sorted(expected) == sorted(got)
    for key in expected:
        a, b = as_numpy(expected[key]), as_numpy(got[key])
        if not (a.dtype == np.uint32 and b.dtype == np.int32):
            assert a.dtype == b.dtype, f"{key}: dtype {a.dtype} != {b.dtype}"
        assert_same(a, b, key)


def packet_fields(packet) -> tuple:
    """A packet of either package as (class name, dataclass fields), enums
    by name, so that airjax's packets and the port's compare."""

    def factory(items):
        return {k: (v.name if isinstance(v, enum.Enum) else v) for k, v in items}

    return type(packet).__name__, dataclasses.asdict(packet, dict_factory=factory)


@contextlib.contextmanager
def airjax_builders_cached():
    """airjax's sharded and channel step builders memoized by their
    arguments while the context lasts, so that each shape jit-compiles once
    in a test module instead of once a call. A built step is a pure
    function of the builder's arguments, so every result is the same."""
    from airjax.parallel import channels, halo

    names = {halo: ("build_sharded_decoder", "build_sharded_decoder_compact", "build_sharded_decoder_extended",
                    "build_sharded_decoder_extended_compact"),
             channels: ("build_channel_decoder", "build_channel_decoder_extended")}

    def cached(build):
        steps = {}

        def wrapper(*args, **kw):
            key = (args, tuple(sorted(kw.items())))
            try:
                hash(key)
            except TypeError:
                return build(*args, **kw)
            if key not in steps:
                steps[key] = build(*args, **kw)
            return steps[key]

        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for module, builders in names.items():
            for name in builders:
                mp.setattr(module, name, cached(getattr(module, name)))
        yield


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")
