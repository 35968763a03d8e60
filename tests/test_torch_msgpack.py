"""The port's msgpack codec (``utils/msgpack.py``) against
``flax.serialization``, on the CPU.

Every tree goes both ways: the port's bytes equal flax's byte for byte,
flax reads the port's bytes and the port reads flax's, and every leaf
comes back equal in dtype, shape and bits. Covered: nested and empty
maps, every integer and string width msgpack defines, floats, None,
bools, bytes, lists; int8, bool, fp32, fp64 and bf16 arrays (bf16 comes
back as a torch tensor: numpy has no bfloat16 and the card's machine no
``ml_dtypes``); numpy scalars; a JAX quant tree; flax's chunked arrays
(the chunk size set low in both codecs). Unsupported input raises.
"""

from __future__ import annotations

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from range_view_3d_detection_torch import serving
from range_view_3d_detection_torch.utils import msgpack as tmsgpack
from range_view_3d_detection_tpu.models.detector import Detector
from range_view_3d_detection_tpu.models.quantized import calibrate_scales


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _bits(x):
    """(type tag, dtype name, shape, raw bytes) of a leaf."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        tag = "array" if x.dim() else "scalar"
        return (tag, "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes())
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.name, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("scalar", x.dtype.name, (), np.asarray(x).tobytes())
    return (type(x).__name__, None, None, x)


def _assert_same(got, want):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert _bits(a) == _bits(b), path


def _tree():
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "params": {
            "Conv_0": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                       "bias": np.zeros(8, np.float32)},
            "empty": {},
            "bn": {"scale": rng.normal(size=300).astype(np.float64)},
        },
        "ints": ints,
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "misc": [None, True, False, b"", b"\x00" * 300, "", "a" * 31, "b" * 32,
                 "c" * 256, "d" * 70000, "é"],
        "many": {f"k{i}": i for i in range(20)},
        "long": list(range(70000)),
        "i8": rng.integers(-128, 128, (5, 7)).astype(np.int8),
        "mask": rng.uniform(size=(4, 4)) > 0.5,
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(2, 9)), jnp.bfloat16)),
        "scalars": {"f": np.float32(1.25), "i": np.int64(-7), "b": np.bool_(True),
                    "bf": np.asarray(jnp.bfloat16(0.5))[()]},
        "zero_d": np.asarray(np.float32(3.0)),
        "sizes": [np.zeros((0, 3), np.float32), np.zeros(17, np.uint8),
                  np.zeros(70000, np.uint8)],
    }


def test_round_trips_with_flax():
    tree = _tree()
    ours = tmsgpack.msgpack_serialize(tree)
    theirs = fser.msgpack_serialize(tree)
    assert ours == theirs
    _assert_same(tmsgpack.msgpack_restore(theirs), fser.msgpack_restore(theirs))
    # The port's bf16 leaves (torch tensors) are written as flax writes
    # ml_dtypes arrays, and read back by flax bit for bit.
    back = tmsgpack.msgpack_restore(ours)
    assert isinstance(back["bf16"], torch.Tensor) and back["bf16"].dtype == torch.bfloat16
    again = tmsgpack.msgpack_serialize(back)
    assert again == theirs
    restored = fser.msgpack_restore(again)
    np.testing.assert_array_equal(restored["bf16"].view(np.int16),
                                  tree["bf16"].view(np.int16))
    # float32, which msgpack-python reads but never writes unasked.
    assert tmsgpack.msgpack_restore(b"\xca\x3f\xc0\x00\x00") == 1.5


def test_jax_quant_tree_round_trips():
    cfg = graft._flagship_config(tiny=True)
    batch = serving._sample_inputs(1, 4, 32, cfg.in_channels)
    model = Detector(cfg)
    variables = model.init(jax.random.PRNGKey(0), *batch, train=False)
    qtree = jax.device_get(calibrate_scales(model, variables, [batch]))
    theirs = fser.msgpack_serialize(qtree)
    assert tmsgpack.msgpack_serialize(qtree) == theirs
    got = tmsgpack.msgpack_restore(theirs)
    _assert_same(got, fser.msgpack_restore(theirs))
    assert tmsgpack.msgpack_serialize(got) == theirs


def test_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"a": {"big": rng.normal(size=(5, 7)).astype(np.float32),
                  "small": np.arange(4, dtype=np.int32)},
            "bf": np.asarray(jnp.asarray(rng.normal(size=(50,)), jnp.bfloat16))}
    theirs = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in theirs
    assert tmsgpack.msgpack_serialize(tree) == theirs
    got = tmsgpack.msgpack_restore(theirs)
    _assert_same(got, fser.msgpack_restore(theirs))
    assert got["a"]["big"].shape == (5, 7) and got["bf"].shape == (50,)
    assert tmsgpack.msgpack_serialize(got) == theirs


def test_unsupported_input_raises():
    with pytest.raises(TypeError, match="tuple"):
        tmsgpack.msgpack_serialize({"a": (1, 2)})
    with pytest.raises(TypeError, match="complex"):
        tmsgpack.msgpack_serialize({"a": np.zeros(2, np.complex64)})
    with pytest.raises(TypeError, match="complex"):
        tmsgpack.msgpack_restore(fser.msgpack_serialize({"a": 1 + 2j}))
    with pytest.raises(TypeError, match="set"):
        tmsgpack.msgpack_serialize({"a": {1, 2}})
    with pytest.raises(TypeError, match="ext type 5"):
        tmsgpack.msgpack_restore(b"\xd4\x05\x00")
    with pytest.raises(ValueError, match="map key"):
        tmsgpack.msgpack_restore(b"\x81\x01\x02")  # {1: 2}
    with pytest.raises(ValueError, match="unknown type byte 0xc1"):
        tmsgpack.msgpack_restore(b"\xc1")
    with pytest.raises(ValueError, match="ends inside"):
        tmsgpack.msgpack_restore(fser.msgpack_serialize({"a": np.zeros(8)})[:-3])
