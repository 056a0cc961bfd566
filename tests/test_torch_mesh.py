"""The port's process meshes (``sat_tpu_torch/parallel/mesh.py``) on the CPU.

Ranks run as subprocesses with one torch thread each
(``tests/_torch_mesh_rank.py``), in gloo groups joined through a file in
``tmp_path`` (no port, so xdist workers never race for one): a pair (2
ranks: DP ``(2,)`` and TP ``(1, 2)``), a quad (4 ranks: TP ``(2, 2)``), and
one rank joined through torchrun's variables.  The groups start once per
module and run while this process computes the references: JAX's
8-device mesh step (``tests/test_parallel.py::make_setup``) and the port's
one-process Trainer, beam search and ``serve``."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_rank as RK
import test_parallel
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from sat_tpu.parallel import mesh as JM
from sat_tpu.train import checkpoints as JC
from sat_tpu_torch import serve
from sat_tpu_torch.data.preprocess import make_synthetic_dataset
from sat_tpu_torch.decode.beam import beam_search, greedy_decode
from sat_tpu_torch.models.jax_import import jax_leaf_map, to_jax_layout
from sat_tpu_torch.parallel import mesh as M
from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint
from sat_tpu_torch.train.loop import Trainer
from sat_tpu_torch.train.opt_state import flatten, optax_state_dict

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SIZES = {"pair": 2, "quad": 4, "torchrun": 1}
SERVE_RUNS = {"beam": ["--mesh_shape", "2"],
              "multinomial": ["--mesh_shape", "2", "--sample_method", "multinomial",
                              "--temperature", "1.5"],
              "tp": ["--mesh_shape", "1", "2", "--mesh_axes", "data", "model"]}
TIMEOUT = 600


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, then every group started; JAX's make_setup for the
    references."""
    root = tmp_path_factory.mktemp("mesh")
    cfg_j, variables, train_step, batch, model_j = test_parallel.make_setup()
    ckpt = str(root / "tiny.ckpt")
    JC.save_checkpoint(ckpt, cfg_j, jax.device_get(variables))
    np.savez(root / "batch.npz", **batch)
    ds = make_synthetic_dataset(str(root / "ds"), n_train=16, n_val=8, n_test=2,
                                image_size=32, max_cap_length=8)
    fit_kw = dict(json=ds, encoder_arch="shufflenet_v2_x0_5", input_size=32,
                  embed_dim=8, attention_dim=8, decoder_dim=16, batch=4, epochs=1,
                  workers=0, val_beamk=2, val_max_len=5, val_interval=1,
                  log_every=1, seed=0, native_decode=False)
    out = root / "out"
    out.mkdir()
    serve_argv = ["--checkpoint", ckpt, "--images", os.path.dirname(ds),
                  "--batch", "4", "--beamk", "2", "--max_gen_length", "5",
                  "--precision", "32"]
    ctx = dict(ckpt=ckpt, batch=str(root / "batch.npz"), out=str(out),
               tp_ckpt=str(root / "tp.ckpt"), fit_kw=fit_kw,
               log_root=str(root / "logs"), serve_argv=serve_argv,
               serve_runs=SERVE_RUNS,
               serve_out={k: str(root / f"serve_{k}.jsonl") for k in SERVE_RUNS})
    ctx_path = str(root / "ctx.json")
    json.dump(ctx, open(ctx_path, "w"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs = {}
    for group, n in SIZES.items():
        genv = dict(env)
        if group == "torchrun":
            genv.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                        WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                        **{M.BACKEND_VAR: "gloo"})
        logs = [open(root / f"{group}{r}.log", "wb") for r in range(n)]
        procs[group] = [(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_mesh_rank.py"), group,
             str(r), str(n), str(root / f"{group}.init"), ctx_path],
            env=genv, stdout=logs[r], stderr=subprocess.STDOUT), logs[r])
            for r in range(n)]
    yield dict(ctx=ctx, root=root, procs=procs, cfg_j=cfg_j, variables=variables,
               train_step=train_step, batch=batch)
    for group in procs.values():
        for p, log in group:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()


def results(setup, group, job):
    """Every rank's results of ``job``, once its group has exited cleanly."""
    for r, (p, log) in enumerate(setup["procs"][group]):
        try:
            p.wait(timeout=TIMEOUT)
        finally:
            log.flush()
        text = open(setup["root"] / f"{group}{r}.log", errors="replace").read()
        assert p.returncode == 0, f"{group} rank {r}:\n{text[-4000:]}"
    return [torch.load(os.path.join(setup["ctx"]["out"], f"{group}_{job}_rank{r}.pt"),
                       weights_only=False) for r in range(SIZES[group])]


def _close(got, jax8, jax64):
    """tests/test_parallel.py:83's tolerance for a gradient leaf, measured
    from JAX's float64 gradient: the port may be that much farther from it
    than JAX's 8-device float32 gradient is.  (A few BatchNorm leaves of
    the late stages are ill-conditioned: JAX's own float32 mesh gradient
    lies up to 5.5e-7 from its float64 one where the tolerance is 5e-7.)"""
    got, jax8, jax64 = (np.asarray(x, np.float64) for x in (got, jax8, jax64))
    atol = max(5e-4 * float(max(np.abs(jax8).max(), 1e-3)), 2e-7)
    excess = np.abs(got - jax64) - np.abs(jax8 - jax64)
    assert excess.max() <= atol, (excess.max(), atol)


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's gradient of make_setup's step on the 8-device mesh, and on one
    device in float64."""
    mesh8 = JM.create_mesh((8,), ("data",), jax.devices())
    step = setup["train_step"]
    g, loss = jax.jit(step)(
        JM.replicate_tree(jax.device_get(setup["variables"]), mesh8),
        JM.shard_batch(setup["batch"], mesh8), jax.random.PRNGKey(7))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32
            else np.asarray(x), jax.device_get(setup["variables"]))
        g64, _ = jax.jit(step)(v64, setup["batch"], jax.random.PRNGKey(7))
        g64 = jax.device_get(g64)
    return jax.device_get(g), float(loss), g64


@pytest.fixture(scope="module")
def leaf_map(setup):
    model, _ = load_model_from_checkpoint(setup["ctx"]["ckpt"], device="cpu")
    return jax_leaf_map(model)


def _jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _full(res, name, vocab_axis_of):
    """A leaf's full gradient from the ranks of one model group (those with
    data coordinate 0), slices joined where vocab TP cut them."""
    group = [r for r in res if r["coords"][0] == 0]
    group.sort(key=lambda r: r["coords"][-1])
    g = group[0]["grads"][name]
    ax = vocab_axis_of(name)
    if ax is None or len(group) == 1:
        return g
    return torch.cat([r["grads"][name] for r in group], dim=ax)


def _vocab_axis(name):
    keys = name.split(".")
    if "embedding" in keys:
        return 0
    if "out_proj" in keys:
        return 1 if keys[-1] == "w" else 0
    return None


def test_dp_gradients_match_jax_mesh(setup, jax_grads, leaf_map):
    """Two DP ranks sum to JAX's 8-device gradient (dropout off), at
    tests/test_parallel.py:83's tolerance (``_close``), and hold the same
    sum."""
    g_jax, loss_jax, g64 = jax_grads
    res = [r["dp"] for r in results(setup, "pair", "grads")]
    assert abs(res[0]["loss"] - loss_jax) < 1e-5
    assert res[0]["grads"].keys() == leaf_map.keys()
    for name, (path, perm) in leaf_map.items():
        for r in res[1:]:
            assert torch.equal(r["grads"][name], res[0]["grads"][name]), name
        _close(to_jax_layout(res[0]["grads"][name], perm), _jax_leaf(g_jax, path),
               _jax_leaf(g64, path))


@pytest.mark.parametrize("group,model_size", [("pair", 2), ("quad", 2)])
def test_tp_vocab_sharding_matches_dp(setup, jax_grads, leaf_map, group, model_size):
    """Vocab TP on (1, 2) and (2, 2) meshes: each rank holds V / 2 rows of
    the embedding's gradient and V / 2 columns of out_proj's, and the
    joined slices and every replicated leaf match JAX's DP gradient."""
    g_jax, loss_jax, g64 = jax_grads
    res = [r["tp"] for r in results(setup, group, "grads")]
    assert abs(res[0]["loss"] - loss_jax) < 1e-5
    for r in res:
        assert tuple(r["grads"]["decoder.embedding"].shape) == (RK.V // model_size, 8)
        assert tuple(r["grads"]["decoder.out_proj.w"].shape) == (8, RK.V // model_size)
        assert tuple(r["grads"]["decoder.out_proj.b"].shape) == (RK.V // model_size,)
    for name, (path, perm) in leaf_map.items():
        _close(to_jax_layout(_full(res, name, _vocab_axis), perm),
               _jax_leaf(g_jax, path), _jax_leaf(g64, path))


def test_tp_shardings_cover_optimizer_state(setup):
    """tree_shardings' path rules shard the Adam moments of both tables
    (they mirror the weights), and a TP Trainer's optimizer holds moments
    of its slices only."""
    cfg = RK.trainer_cfg(opt="adam")
    tr = Trainer(cfg, device="cpu", steps_per_epoch=10)
    tr.train_step(RK.make_batch(1))
    tree = optax_state_dict(tr.cfg, tr.model, tr.optimizer, 1)
    fake = M.Mesh((1, 2), ("data", "model"), rank=1)
    full = _arrays(tree)
    axes = {k: v for k, v in flatten(M.tree_shardings(tree, fake)).items() if k in full}
    emb = {k: v for k, v in axes.items() if k.endswith("decoder/embedding")}
    assert len(emb) == 2 and all(v == 0 for v in emb.values())       # mu, nu
    out = {k: v for k, v in axes.items() if k.endswith("out_proj/w")}
    assert len(out) == 2 and all(v == 1 for v in out.values())
    assert sum(v is not None for v in axes.values()) == 6            # + out_proj/b
    placed = _arrays(M.place_tree(tree, fake))
    for k in emb:
        np.testing.assert_array_equal(placed[k], full[k][RK.V // 2:])
    for r in results(setup, "pair", "trainer"):
        assert r["tp_adam"]["moments"] == {"exp_avg": (RK.V // 2, 8),
                                           "exp_avg_sq": (RK.V // 2, 8)}


@pytest.fixture(scope="module")
def one_process_beam(setup):
    model, _ = load_model_from_checkpoint(setup["ctx"]["ckpt"], device="cpu")
    annots = model.encode(torch.from_numpy(setup["batch"]["images"]).float() / 255.0)
    r = beam_search(model.decoder, model.cfg, annots, beamk=3, max_gen_length=5,
                    rescore_method="LN", fused=False)
    g = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=5, fused=False)
    return (r.tokens, r.scores), (g.tokens, g.scores)


@pytest.mark.parametrize("group,tag", [("pair", "dp"), ("pair", "tp"), ("quad", "tp")])
def test_tp_beam_decode_matches_dp(setup, one_process_beam, group, tag):
    """Beam search (the plain path and the step kernels' plain version) and
    greedy on each rank's rows, gathered: the one-process tokens, and its
    scores within 1e-5; under TP from V / 2 table rows and columns; and
    replicate_tree gives every rank rank 0's tree."""
    (bt, bs), (gt, gs) = one_process_beam
    for r in results(setup, group, "beam"):
        res = r[tag]
        want = RK.V // 2 if tag == "tp" else RK.V
        assert res["table_rows"] == res["out_cols"] == want
        assert res["replicated"]["x"].tolist() == [0.0, 0.0]     # rank 0's
        assert res["replicated"]["y"].tolist() == [0, 0, 0]
        for key, (t, s) in (("beam_False", (bt, bs)), ("beam_True", (bt, bs)),
                            ("greedy", (gt, gs))):
            np.testing.assert_array_equal(res[key][0].numpy(), t.numpy(), err_msg=key)
            np.testing.assert_allclose(res[key][1].numpy(), s.numpy(), atol=1e-5,
                                       rtol=0, err_msg=key)


def _arrays(tree):
    return {k: v for k, v in flatten(tree).items() if not isinstance(v, dict)}


def _gaps(got, want):
    """(the largest gap of a weight, of a BatchNorm running statistic)."""
    gap = lambda k: float((got[k].double() - want[k].double()).abs().max())
    return (max(gap(k) for k in want if "running" not in k),
            max([gap(k) for k in want if "running" in k] or [0.0]))


def _assert_state(got, want):
    w, st = _gaps(got, want)
    assert w < STEP_TOL and st < STATS_TOL, (w, st)


@pytest.fixture(scope="module")
def one_process_steps():
    """The port's one-process Trainer on the global batches (the ranks'
    reference), and its microbatch run on the ranks' chunk composition."""
    batches = [RK.make_batch(s) for s in (1, 2, 3)]
    full = RK.run_steps(Trainer(RK.trainer_cfg(), device="cpu", steps_per_epoch=10),
                        batches)
    micro = RK.run_steps(
        Trainer(RK.trainer_cfg(microbatch=4, **RK.NO_AUGMENT), device="cpu",
                steps_per_epoch=10),
        [RK.recompose(b, 2, 2) for b in batches[:2]])
    return full, micro


# The measured gaps after three steps (this file's CPU run): the losses
# within 1.2e-6; the weights 3.6e-7 (DP against one process) and 6.1e-6
# (microbatch chunks); the running statistics 1.8e-5 and 1.4e-4 (of
# variances near 1.4), all in the late stages' variances, whose one-pass
# formula cancels where the mean dwarfs the spread (4 images of a 1 x 1
# map per rank): summing per rank first rounds differently from one mean.
STEP_TOL = 1e-5
STATS_TOL = 5e-4


def test_dp_trainer_matches_one_process(setup, one_process_steps):
    """Three Trainer steps on two DP ranks, with dropout, the augment's
    crop, flip and noise drawn for the global batch, and the encoder
    finetuned from step 1 (BatchNorm on the global batch's statistics),
    against one process on the global batch: the losses, the weights and
    the running statistics within STEP_TOL / STATS_TOL; both ranks alike."""
    (losses, state), _ = one_process_steps
    res = [r["dp"] for r in results(setup, "pair", "trainer")]
    for r in res:
        for got, want in zip(r["losses"], losses):
            for k in want:
                assert abs(got[k] - want[k]) < STEP_TOL, (k, got, want)
        _assert_state(r["state"], state)
    assert _gaps(res[0]["state"], res[1]["state"]) == (0.0, 0.0)


def test_tp_trainer_matches_dp(setup):
    """Three Trainer steps under vocab TP (1, 2) equal the DP run's, the
    table slices joined, the losses alike."""
    res = results(setup, "pair", "trainer")
    dp = res[0]["dp"]
    joined = dict(res[0]["tp"]["state"])
    for name in ("decoder.embedding", "decoder.out_proj.w", "decoder.out_proj.b"):
        joined[name] = torch.cat([r["tp"]["state"][name] for r in res], dim=_vocab_axis(name))
    _assert_state(joined, dp["state"])
    for got, want in zip(res[0]["tp"]["losses"], dp["losses"]):
        assert all(abs(got[k] - want[k]) < STEP_TOL for k in want)


def test_microbatch_on_ranks_matches_chunk_composition(setup, one_process_steps):
    """microbatch 4 on two ranks chunks each rank's rows (2 per chunk): it
    equals one process whose chunk i is both ranks' chunk i (the stated
    departure from JAX's contiguous chunks of the global batch)."""
    _, (losses, state) = one_process_steps
    for r in results(setup, "pair", "trainer"):
        for got, want in zip(r["micro"]["losses"], losses):
            assert all(abs(got[k] - want[k]) < STEP_TOL for k in want)
        _assert_state(r["micro"]["state"], state)


def test_tp_checkpoint_reads_in_jax(setup):
    """Rank 0 writes the TP Trainer's checkpoint with the tables gathered:
    JAX's load_checkpoint reads the full (V, E) embedding, (E, V) out_proj
    and their Adam moments, equal to the ranks' slices joined."""
    res = results(setup, "pair", "trainer")
    _, tree = JC.load_checkpoint(setup["ctx"]["tp_ckpt"])
    dec = tree["params"]["decoder"]
    assert np.shape(dec["embedding"]) == (RK.V, 8)
    assert np.shape(dec["out_proj"]["w"]) == (8, RK.V)
    joined = torch.cat([r["tp_adam"]["state"]["decoder.embedding"] for r in res])
    np.testing.assert_array_equal(np.asarray(dec["embedding"]), joined.numpy())
    mu = [v for k, v in _arrays(tree["opt_state"]).items()
          if k.endswith("mu/decoder/embedding")]
    assert len(mu) == 1 and np.shape(mu[0]) == (RK.V, 8)


def test_two_rank_fit_has_one_writer(setup):
    """Trainer.fit on two ranks (tests/test_multihost.py::
    test_two_process_trainer_fit): one version directory chosen by rank 0,
    only rank 0 writing logs and checkpoints, equal validation metrics."""
    r0, r1 = results(setup, "pair", "fit")
    assert r0["logdir"] == r1["logdir"]
    assert r0["is_main"] and not r1["is_main"]
    assert r0["writes"] == (True, True, True) and r1["writes"] == (False, False, False)
    assert r0["val_batch"] == 4
    assert r0["metrics"] == r1["metrics"] and np.isfinite(r0["metrics"]["bleu4"])
    base = os.path.join(setup["ctx"]["log_root"], "default")
    assert sorted(os.listdir(base)) == ["version_0"]
    files = os.listdir(r0["logdir"])
    assert "last.ckpt" in files and any(f.startswith("epoch=") for f in files)


@pytest.mark.parametrize("run", sorted(SERVE_RUNS))
def test_two_rank_serve_matches_one_rank(setup, run, tmp_path):
    """serve on two ranks (DP beam, DP multinomial sampling, vocab TP)
    writes the one-rank JSONL: the same images, captions and scores."""
    results(setup, "pair", "serve")
    extra = [a for a in SERVE_RUNS[run] if a not in ("--mesh_shape", "--mesh_axes", "1",
                                                      "2", "data", "model")]
    ref = str(tmp_path / "one.jsonl")
    serve.main(setup["ctx"]["serve_argv"] + extra + ["--output", ref], device="cpu")
    want = [json.loads(x) for x in open(ref)]
    got = [json.loads(x) for x in open(setup["ctx"]["serve_out"][run])]
    assert len(got) == len(want) == 26
    for g, w in zip(got, want):
        assert (g["image"], g["caption"]) == (w["image"], w["caption"])
        assert abs(g["score"] - w["score"]) < 1e-5


def test_torchrun_variables(setup, monkeypatch):
    """maybe_initialize_distributed: torchrun's variables join a group (the
    backend from SAT_TORCH_DIST_BACKEND); without MASTER_ADDR nothing
    happens; WORLD_SIZE without RANK raises."""
    (r,) = results(setup, "torchrun", "torchrun")
    assert r == {"backend": "gloo", "world": 1, "mesh": ((1,), 1)}
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert M.maybe_initialize_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="BOTH WORLD_SIZE and RANK"):
        M.maybe_initialize_distributed()


def test_mesh_layout_without_a_group():
    """A mesh's coordinates are row-major, as np.reshape lays out JAX's
    devices; rows, draws and vocab slices are this rank's blocks; a mesh
    that is not the world raises, naming the launch."""
    m = M.Mesh((2, 2), ("data", "model"), rank=2)
    assert m.coords == (1, 0) and (m.model_size, m.model_rank, m.size) == (2, 0, 4)
    x = torch.arange(8)
    assert m.rows(x).tolist() == [4, 5]
    g = lambda shape: torch.arange(int(np.prod(shape))).reshape(shape)
    assert m.draw(g, (1, 3), axis=1).tolist() == [[6, 7, 8]]
    assert m.vocab_slice(torch.arange(8).reshape(2, 4), 1).tolist() == [[0, 1], [4, 5]]
    assert M.create_mesh().size == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        M.create_mesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="differ in length"):
        M.create_mesh((1,), ("data", "model"))


def test_collectives_take_no_host_tensor_without_gloo(setup):
    """With the backend taken for one without a host side (NCCL), a DP
    ``validate()`` (its host references gathered), a TP step, the TP
    checkpoint tree (numpy leaves gathered) and ``replicate_tree`` hand
    ``torch.distributed`` only tensors that ``mesh._wire`` put on the
    backend's device (``tests/_torch_mesh_rank.py::job_wire``)."""
    res = results(setup, "pair", "wire")
    for phase in ("validate", "tp_step", "gather_tree", "replicate_tree"):
        for r in res:
            assert r[phase], phase
            assert all(ok for _, ok in r[phase]), (phase, r[phase])
    names = {n for r in res for n, _ in r["validate"] + r["gather_tree"]}
    assert {"all_gather_into_tensor"} <= names
    assert {n for n, _ in res[0]["replicate_tree"]} == {"broadcast"}
    assert res[0]["table"] == res[1]["table"] == (RK.V, 8)
    assert res[0]["metrics"] == res[1]["metrics"]


def test_wire_puts_host_tensors_on_the_card(monkeypatch):
    """``_wire``: gloo takes host tensors (half types as float32); any other
    backend takes them on this process's card (here ``meta`` stands in for
    it), in their own type."""
    x = torch.ones(3, dtype=torch.bfloat16)
    monkeypatch.setattr(M, "_gloo", lambda group: True)
    assert M._comm_device(None) == torch.device("cpu")
    assert M._wire(x, None).dtype == torch.float32
    monkeypatch.setattr(M, "_gloo", lambda group: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert M._comm_device(None) == torch.device("cuda", 0)
    monkeypatch.setattr(M, "_comm_device", lambda group: torch.device("meta"))
    for copy in (False, True):
        y = M._wire(x, None, copy)
        assert (y.device.type, y.dtype, y.shape) == ("meta", torch.bfloat16, x.shape)


def test_one_rank_mesh_is_the_default():
    """Without a mesh every ``mesh`` argument is ``ONE_RANK``, whose
    collectives return their input; a decoder that holds a vocab slice
    needs the mesh it was sharded over."""
    from sat_tpu_torch.models.decoder import embed_tokens, init_decoder_params
    one = M.ONE_RANK
    x = torch.arange(6.0).reshape(3, 2)
    assert one.sum(x) is x and one.fetch_global(x) is x
    assert one.gather(x).shape == (1, 3, 2) and one.all_true(True)
    assert one.gather_objects("a") == ["a"] and one.broadcast_object("a") == "a"
    assert not one.vocab_sharded(RK.V)
    cfg = RK.tiny_cfg(encoder_dim=4)
    params = init_decoder_params(torch.Generator().manual_seed(0), cfg)
    ids = torch.tensor([1, 2])
    assert embed_tokens(params, ids, cfg).shape == (2, 8)
    M.shard_vocab_params(params, M.Mesh((1, 2), ("data", "model")))
    with pytest.raises(ValueError, match="the mesh it was sharded over"):
        embed_tokens(params, ids, cfg)
