"""The port's own copies of two framework-free modules of the JAX package,
pinned to the originals: ``config.py`` (every dataclass field by field, every
constant, every preset function) and ``utils/native.py`` (the same ctypes
surface over the same ``native/libirnative.so``), and of the fixture BPE
vocabulary (``models/bpe_fixture/``, byte for byte). The port imports nothing
of the JAX package, so these copies are all that keeps a configuration
written for one package meaning the same in the other."""

import dataclasses
import inspect

import numpy as np
import pytest

import image_retrieval_tpu.config as jcfg
import image_retrieval_tpu.utils.native as jnative
import image_retrieval_tpu_torch.config as tcfg
import image_retrieval_tpu_torch.utils.native as tnative

DATACLASSES = sorted(n for n, o in vars(jcfg).items()
                     if inspect.isclass(o) and dataclasses.is_dataclass(o)
                     and o.__module__ == jcfg.__name__)
PRESETS = ["vit_b32", "vit_b16", "vit_l14", "vit_b32_serving", "default_config"]
CONSTANTS = sorted(n for n, o in vars(jcfg).items()
                   if n.isupper() and not n.startswith("_"))


def _plain(obj):
    """A config object as nested plain data, so objects of the two packages
    (different classes) compare by content."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def test_same_public_names():
    public = lambda m: {n for n, o in vars(m).items() if not n.startswith("_")
                        and getattr(o, "__module__", m.__name__) == m.__name__
                        and not inspect.ismodule(o)}
    assert public(tcfg) == public(jcfg)
    assert DATACLASSES and CONSTANTS


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_types_defaults(name):
    mine, ref = getattr(tcfg, name), getattr(jcfg, name)
    assert dataclasses.is_dataclass(mine)
    assert mine.__dataclass_params__.frozen == ref.__dataclass_params__.frozen
    got = [(f.name, str(f.type)) for f in dataclasses.fields(mine)]
    want = [(f.name, str(f.type)) for f in dataclasses.fields(ref)]
    assert got == want
    assert _plain(mine()) == _plain(ref())


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_equal(name):
    assert _plain(getattr(tcfg, name)) == _plain(getattr(jcfg, name))


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal(name):
    assert _plain(getattr(tcfg, name)()) == _plain(getattr(jcfg, name)())


@pytest.mark.parametrize("arch", ["vit_b32", "vit_b16", "vit_l14"])
def test_serving_config_equal(arch):
    mine = tcfg.serving_config(getattr(tcfg, arch)())
    ref = jcfg.serving_config(getattr(jcfg, arch)())
    assert _plain(mine) == _plain(ref)
    assert mine.fused_layer_block and mine.int8_matmuls


def test_config_methods_equal():
    assert tcfg.Config().similarity_params == jcfg.Config().similarity_params


def test_native_copy_has_the_same_surface():
    public = lambda m: {n for n, o in vars(m).items() if not n.startswith("_")
                        and inspect.isfunction(o) and o.__module__ == m.__name__}
    assert public(tnative) == public(jnative)
    for name in public(jnative):
        assert (inspect.signature(getattr(tnative, name))
                == inspect.signature(getattr(jnative, name))), name
    assert tnative.available() == jnative.available()


def test_native_copy_decodes_like_the_original(tmp_path):
    if not jnative.available():
        pytest.skip("native/libirnative.so cannot be built here")
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(40 + i, 36, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    for fn in ("decode_preprocess_batch", "decode_preprocess_batch_u8"):
        got, want = getattr(tnative, fn)(paths, 32), getattr(jnative, fn)(paths, 32)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["vocab.json", "merges.txt"])
def test_bpe_fixture_copy_is_byte_for_byte(name):
    """The port tokenizes with its own copy of the fixture vocabulary; the
    copy must be the JAX package's file, byte for byte."""
    import pathlib

    import image_retrieval_tpu.models.tokenizer as jtok
    import image_retrieval_tpu_torch.models.tokenizer as ttok

    mine, ref = pathlib.Path(ttok.FIXTURE_DIR), pathlib.Path(jtok.FIXTURE_DIR)
    assert mine.resolve() != ref.resolve()
    assert mine.resolve().parent == pathlib.Path(ttok.__file__).resolve().parent
    assert (mine / name).read_bytes() == (ref / name).read_bytes()
