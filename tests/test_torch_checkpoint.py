"""The port's checkpoint reader against sat_tpu.train.checkpoints: the same
tree, bit for bit, without flax or msgpack."""

import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from sat_tpu.train import checkpoints as jck
from sat_tpu_torch.train import checkpoints as tck
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

DATA = os.path.join(os.path.dirname(__file__), "data")
CKPTS = ["golden_v1.ckpt", "best_n64_r4_serving.ckpt"]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", CKPTS)
def test_loader_bit_equal(name):
    path = os.path.join(DATA, name)
    jcfg, jtree = jck.load_checkpoint(path)
    tcfg, ttree = tck.load_checkpoint(path)
    assert tcfg.to_dict() == jcfg.to_dict()
    ja, ta = _flatten(jtree), _flatten(ttree)
    assert set(ja) == set(ta)
    for k in ja:
        ref = np.asarray(ja[k])
        got = ta[k].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        assert got.tobytes() == ref.tobytes(), k


@pytest.mark.parametrize("name", CKPTS)
def test_config_header(name):
    path = os.path.join(DATA, name)
    assert (tck.read_checkpoint_config(path).to_dict()
            == jck.read_checkpoint_config(path).to_dict())


def test_unpacker_matches_msgpack():
    """Every msgpack type flax can emit, at each width boundary."""
    value = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 63],
        "floats": [0.5, -1.25e300, float("inf")],
        "str": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 65536, "ü"],
        "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "misc": [None, True, False, list(range(15)), list(range(16)),
                 list(range(70000))],
        "map": {str(i): i for i in range(20)},
        "big_map": {str(i): i for i in range(70000)},
    }
    payload = msgpack.packb(value, use_bin_type=True)
    assert tck.msgpack_restore(payload) == msgpack.unpackb(payload, raw=False)
    single = msgpack.packb(np.float32(2.5).item(), use_single_float=True)
    assert tck.msgpack_restore(single) == 2.5


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int8, np.uint16,
                                   np.float64, "bfloat16"])
def test_array_leaves(dtype):
    rng = np.random.default_rng(0)
    if dtype == "bfloat16":
        arr = jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)
    else:
        arr = (rng.normal(size=(3, 5)) * 50).astype(dtype)
    tree = {"a": {"x": np.asarray(arr)}, "s": np.int64(7), "e": np.zeros((0, 4))}
    got = tck.msgpack_restore(serialization.msgpack_serialize(tree))
    ref = serialization.msgpack_restore(serialization.msgpack_serialize(tree))
    x = got["a"]["x"]
    if dtype == "bfloat16":
        assert x.dtype == torch.bfloat16
        assert x.view(torch.uint16).numpy().tobytes() == np.asarray(
            ref["a"]["x"]).view(np.uint16).tobytes()
    else:
        assert x.numpy().tobytes() == ref["a"]["x"].tobytes()
        assert x.numpy().dtype == ref["a"]["x"].dtype
    assert got["s"].item() == 7 and got["s"].dtype == torch.int64
    assert tuple(got["e"].shape) == (0, 4)


def test_rejects_chunked_and_bad_magic(tmp_path):
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True,
                                   "shape": {"0": 1}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked"):
        tck.msgpack_restore(chunked)
    with pytest.raises(ValueError, match="extension type 9"):
        tck.msgpack_restore(msgpack.packb(msgpack.ExtType(9, b"")))
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"NOTSAT1\n" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a SAT-TPU checkpoint"):
        tck.load_checkpoint(str(bad))
