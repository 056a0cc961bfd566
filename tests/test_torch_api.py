"""sat_tpu_torch's package surface against sat_tpu's, on the CPU: the lazy
public API, the decode route rule on a CUDA device (no card needed: the
rule reads the config and the call's arguments), the Trainer's mesh rule,
and the loader's process shards against JAX's CaptionLoader
(tests/test_multihost.py's pattern)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import sat_tpu
import sat_tpu_torch
from sat_tpu.data import dataset as jax_data
from sat_tpu_torch.data import dataset
from sat_tpu_torch.decode import beam as TB
from test_torch_data import caption_json  # noqa: F401  (fixture)
from test_torch_kernels import _n64
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_public_api_matches_jax():
    """Every name of sat_tpu.__all__, create_mesh included, resolves in
    sat_tpu_torch, to the port's own object."""
    want = list(sat_tpu.__all__)
    assert sorted(sat_tpu_torch.__all__) == sorted(want)
    assert dir(sat_tpu_torch) == sorted(want)
    for name in want:
        obj = getattr(sat_tpu_torch, name)
        if callable(obj):
            assert obj.__module__.startswith("sat_tpu_torch."), name
    assert sat_tpu_torch.create_mesh.__module__ == "sat_tpu_torch.parallel.mesh"
    with pytest.raises(AttributeError):
        sat_tpu_torch.no_such_name


def test_import_does_not_import_torch():
    code = ("import sys, sat_tpu_torch; assert 'torch' not in sys.modules; "
            "sat_tpu_torch.SATConfig(); assert 'torch' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("cfg_kw,noisy,greedy,want", [
    ({}, False, False, "step kernels"),
    ({}, True, False, "plain (decoder_noise)"),
    ({"decoder_layers": 2}, False, False, "plain (decoder_layers 2)"),
    ({"decoder_layers": 2}, True, False, "plain (decoder_layers 2)"),
    ({}, False, True, "loop kernel"),
    ({"vocab_size": 60000}, False, True, "loop kernel"),
    ({"decoder_layers": 2}, False, True, "plain (decoder_layers 2)"),
])
def test_decode_route_on_the_card(cfg_kw, noisy, greedy, want):
    """JAX's rule (use_fused = fused and decoder_layers == 1 and not noisy)
    with the kernels' gates, for a CUDA device without a tensor; the
    selectors follow it for fused=None, and the CPU is always plain."""
    cfg = _n64(**cfg_kw)
    assert TB.decode_route(CUDA, cfg, 49, noisy=noisy, greedy=greedy) == want
    if greedy:
        assert TB.select_fused(None, CUDA, cfg, 49) == {
            "loop kernel": "loop", "step kernels": True}.get(want, False)
    else:
        assert TB.select_beam_fused(None, CUDA, cfg, 49, noisy) is (want == "step kernels")
    assert TB.decode_route(torch.device("cpu"), cfg, 49, noisy=noisy,
                           greedy=greedy) == "plain (not a CUDA device)"


def test_decode_route_explicit_kernels_still_raise():
    """Only fused=None changed meaning: an explicit kernel path outside
    its gate raises, and no route depends on a kernel building."""
    cfg2 = _n64(decoder_layers=2)
    with pytest.raises(ValueError, match="decoder_noise"):
        TB.select_beam_fused(True, CUDA, _n64(), 49, True)
    with pytest.raises(ValueError, match="decoder_layers"):
        TB.select_beam_fused(True, CUDA, cfg2, 49, False)
    with pytest.raises(ValueError, match="decoder_layers"):
        TB.select_fused("loop", CUDA, cfg2, 49)
    # an L whose scores exceed the step kernels' shared memory
    assert TB.decode_route(CUDA, _n64(), 10 ** 6).startswith("plain (L 1000000")


@pytest.mark.parametrize("b", [1, 3])
def test_kernel_inputs_are_contiguous(monkeypatch, b):
    """beam_search's kernel path hands the step wrapper contiguous rows,
    one image too (its k-fold copy was a stride-0 view, which the card's
    wrapper refuses; the CPU's plain version does not look)."""
    from test_torch_kernels import make
    _, tcfg, _, tp = make()
    real, seen = TB.fused_decoder_step, []

    def checked(lw, cfg, *tensors):
        seen.append(all(x.is_contiguous() for x in tensors))
        return real(lw, cfg, *tensors)

    monkeypatch.setattr(TB, "fused_decoder_step", checked)
    a = torch.from_numpy(np.random.default_rng(4).normal(size=(b, 6, 8)).astype(np.float32))
    TB.beam_search(tp, tcfg, a, beamk=3, max_gen_length=4, fused=True)
    assert seen and all(seen)


def test_bf16_decoder_noise_runs():
    """Hidden-state noise on a bf16 model: JAX's scan raises (its float32
    draw turns the bf16 state float32, a fault of the reference not
    copied); the port adds the noise in the state's type."""
    import jax
    import jax.numpy as jnp
    from sat_tpu.decode import beam as JB
    from test_torch_kernels import make
    jcfg, tcfg, jp, tp = make()
    a = np.random.default_rng(2).normal(size=(2, 6, 8)).astype(np.float32)
    jp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    with pytest.raises(TypeError, match="carry"):
        JB.beam_search(jp16, jcfg, jnp.asarray(a, jnp.bfloat16), beamk=2,
                       max_gen_length=4, decoder_noise=0.1)
    tp16 = tp.to(torch.bfloat16)
    res = TB.beam_search(tp16, tcfg, torch.from_numpy(a).to(torch.bfloat16),
                         beamk=2, max_gen_length=4, decoder_noise=0.1)
    assert torch.isfinite(res.scores).all() and res.tokens.shape == (2, 2, 6)


@pytest.mark.parametrize("mesh_shape,mesh_axes", [
    ((2,), ("data",)), ((4, 2), ("data", "model")), ((1, 2), ("data", "model"))])
def test_trainer_raises_for_a_mesh(mesh_shape, mesh_axes):
    """A mesh larger than the world (one process here) raises serve's
    ValueError naming the launch it needs, before anything is built."""
    cfg = _n64(mesh_shape=mesh_shape, mesh_axes=mesh_axes)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
        sat_tpu_torch.Trainer(cfg, device="cpu")


def _pair(js, split, process_index=0, process_count=1, **kw):
    """JAX's and the port's loaders on the same split (no C++ pool)."""
    common = dict(kw, seed=5, native_decode=False, process_index=process_index,
                  process_count=process_count)
    return (jax_data.CaptionLoader(jax_data.CaptionDataset(js, split), 4, 32, **common),
            dataset.CaptionLoader(dataset.CaptionDataset(js, split), 4, 32, **common))


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


SHARDED = {"bucket": dict(bucket=True), "shuffle": dict(shuffle=True)}


@pytest.mark.parametrize("case", list(SHARDED))
def test_loader_shards_reassemble(caption_json, case):
    """Two process loaders' batches concatenate to the one-process batches
    (same order, the global batch's caption trim), val crops."""
    kw = dict(SHARDED[case], train=False)
    full = _epochs(_pair(caption_json, "train", **kw)[1])
    p0 = _epochs(_pair(caption_json, "train", 0, 2, **kw)[1])
    p1 = _epochs(_pair(caption_json, "train", 1, 2, **kw)[1])
    for fe, ae, be in zip(full, p0, p1):
        assert len(fe) == len(ae) == len(be) == 3
        for f, a, b in zip(fe, ae, be):
            for k in ("images", "captions", "lengths"):
                np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), f[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("process_index", [0, 1])
def test_loader_shards_match_jax(caption_json, process_index, train):
    """Each process's batches bit for bit with JAX's loader of the same
    process_index: its rows, its crops (seeded [seed, 5, process_index,
    epoch, batch]) and the global trim, over two epochs."""
    ref, got = _pair(caption_json, "train", process_index, 2, bucket=True,
                     train=train)
    for re_, ge in zip(_epochs(ref), _epochs(got)):
        assert len(re_) == len(ge) == 3
        for r, g in zip(re_, ge):
            assert r.keys() == g.keys()
            for k in r:
                assert r[k].shape == g[k].shape and r[k].dtype == g[k].dtype, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_loader_rejects_bad_process_config(caption_json):
    """JAX's two checks, raised as ValueError with JAX's messages."""
    ds = dataset.CaptionDataset(caption_json, "train")
    jds = jax_data.CaptionDataset(caption_json, "train")
    for kw, msg in ((dict(batch_size=9), "not divisible by 2 processes"),
                    (dict(batch_size=8, drop_last=False), "requires drop_last")):
        with pytest.raises(AssertionError, match=msg):
            jax_data.CaptionLoader(jds, input_size=32, process_index=0,
                                   process_count=2, native_decode=False, **kw)
        with pytest.raises(ValueError, match=msg):
            dataset.CaptionLoader(ds, input_size=32, process_index=0,
                                  process_count=2, native_decode=False, **kw)
