"""repro_torch.configs against repro.configs: the copied registry.

Mirrors ``tests/test_configs.py`` on the port's copy (geometry reproduces
the published sizes, padded vocabularies, the shape registry, the skip
matrix, the reduced configs, unknown names), and holds every
``ArchConfig`` and ``ShapeSpec`` field for field to the reference's
(``dataclasses.asdict``, exactly equal), with the derived counts too.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as rcfg  # noqa: E402
from repro.configs import base as rbase  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, applicable  # noqa: E402

# name -> (expected total params, expected active params), billions
# (tests/test_configs.py's table).
PUBLISHED = {
    "phi3-medium-14b": (14.0, 14.0),
    "internlm2-1.8b": (1.8, 1.8),
    "smollm-135m": (0.135, 0.135),
    "llama3-8b": (8.0, 8.0),
    "seamless-m4t-large-v2": (2.3, 2.3),
    "arctic-480b": (480.0, 17.0),
    "qwen2-moe-a2.7b": (14.3, 2.7),
    "mamba2-370m": (0.37, 0.37),
    "pixtral-12b": (12.4, 12.4),
    "zamba2-7b": (7.0, 7.0),
}


def test_registry_names_equal_the_reference():
    assert ARCH_NAMES == rcfg.ARCH_NAMES


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_config_equals_the_reference(name):
    port, ref = get_config(name), rcfg.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.padded_vocab() == ref.padded_vocab()
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shape_spec_equals_the_reference(shape):
    assert dataclasses.asdict(SHAPES[shape]) == \
        dataclasses.asdict(rbase.SHAPES[shape])
    assert dataclasses.asdict(SHAPES[shape].reduced()) == \
        dataclasses.asdict(rbase.SHAPES[shape].reduced())
    for name in ARCH_NAMES:
        assert applicable(get_config(name), SHAPES[shape]) == \
            rbase.applicable(rcfg.get_config(name), rbase.SHAPES[shape])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_counts_match_published(name):
    cfg = get_config(name)
    total, active = PUBLISHED[name]
    assert cfg.param_count() / 1e9 == pytest.approx(total, rel=0.15), \
        f"{cfg.param_count()/1e9:.2f}B vs published {total}B"
    assert cfg.active_param_count() / 1e9 == pytest.approx(active, rel=0.15)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_padded_vocab_divisible(name):
    cfg = get_config(name)
    assert cfg.padded_vocab() % 256 == 0
    assert cfg.padded_vocab() >= cfg.vocab_size
    assert cfg.padded_vocab() - cfg.vocab_size < 256


def test_shape_registry():
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}
    assert SHAPES["train_4k"].global_batch == 256
    assert SHAPES["long_500k"].seq_len == 524288


def test_skip_matrix_is_exactly_eight():
    skips = [(a, s) for a in ARCH_NAMES for s in SHAPES
             if not applicable(get_config(a), SHAPES[s])]
    assert len(skips) == 8
    assert all(s == "long_500k" for _, s in skips)
    runners = {a for a in ARCH_NAMES
               if applicable(get_config(a), SHAPES["long_500k"])}
    assert runners == {"mamba2-370m", "zamba2-7b"}  # ssm + hybrid only


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_configs_are_small(name):
    r = get_config(name).reduced()
    assert r.d_model <= 64 and r.vocab_size <= 512
    assert r.family == get_config(name).family
    assert r.param_count() < 5e6


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("gpt-17")
