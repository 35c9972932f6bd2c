"""airjax_torch.config.PipelineConfig against airjax/config.py: every field
with its default, the four properties, and airjax's keyword arguments."""

import dataclasses

import pytest

from airjax import config as jconfig
from airjax_torch import config as tconfig

PROPERTIES = ("frame_samples", "window_len", "halo", "bytes_per_frame")


def test_fields_and_defaults_equal_airjax():
    assert dataclasses.asdict(tconfig.DEFAULT_CONFIG) == dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    assert [f.name for f in dataclasses.fields(tconfig.PipelineConfig)] == [
        f.name for f in dataclasses.fields(jconfig.PipelineConfig)]


@pytest.mark.parametrize("kwargs", [{}, {"gain_db": 40.0, "web_port": 9000},
                                    {"preamble_samples": 8, "bits_per_frame": 56, "samples_per_bit": 4},
                                    {"block_len": 4000, "max_candidates": 32, "high_threshold_derate": 0.75}])
def test_properties_and_keywords_equal_airjax(kwargs):
    ours, theirs = tconfig.PipelineConfig(**kwargs), jconfig.PipelineConfig(**kwargs)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert [getattr(ours, p) for p in PROPERTIES] == [getattr(theirs, p) for p in PROPERTIES]
    if not kwargs:
        assert [getattr(ours, p) for p in PROPERTIES] == [224, 240, 239, 14]


def test_frozen_and_equal_to_the_port_constants():
    from airjax_torch.dsp import demod

    cfg = tconfig.PipelineConfig(gain_db=40.0, web_port=9000)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.gain_db = 1.0
    assert (cfg.window_len, cfg.halo, cfg.frame_samples) == (demod.WINDOW, demod.WINDOW - 1, demod.FRAME_SAMPLES)
