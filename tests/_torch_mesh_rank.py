"""One rank of tests/test_torch_mesh.py's process groups (gloo on the CPU).

    python tests/_torch_mesh_rank.py GROUP RANK WORLD INIT_FILE CTX_JSON

joins a process group of WORLD ranks through ``file://INIT_FILE`` (no
port), runs every job of GROUP in order, and writes each job's results to
``{out}/{GROUP}_{job}_rank{RANK}.pt``.  ``CTX_JSON`` names the inputs the test
process wrote (a checkpoint, a batch, a dataset, images).  The ``torchrun``
group joins through ``maybe_initialize_distributed`` and torchrun's
variables instead.  Imports torch, numpy and the port only: the JAX
references are computed in the test process.  The helpers above ``main``
(the configs and the batch) are shared with the test."""

import json
import os
import sys

import numpy as np
import torch

from sat_tpu_torch.config import SATConfig
from sat_tpu_torch.parallel.mesh import ONE_RANK

V, T, S, R = 32, 6, 32, 5


def tiny_stoi():
    stoi = {f"w{i}": i for i in range(1, V - 3)}
    stoi.update({"<UNK>": V - 3, "<START>": V - 2, "<END>": V - 1, "<PAD>": 0})
    return stoi


def tiny_cfg(**kw) -> SATConfig:
    """tests/test_parallel.py::make_setup's configuration (V 32, E 8, A 8,
    H 16, shufflenet_v2_x0_5 at 32 px, batch 8), complete for a Trainer."""
    d = dict(encoder_arch="shufflenet_v2_x0_5", input_size=S, vocab_size=V,
             vocab_stoi=tiny_stoi(), embed_dim=8, attention_dim=8, decoder_dim=16,
             deep_output=True, batch=8, max_cap_length=T - 2, seed=0)
    d.update(kw)
    return SATConfig(**d)


def trainer_cfg(**kw) -> SATConfig:
    """tiny_cfg with dropout, the augment (crop, flip, noise) and the
    encoder finetuned from step 1: every part a rank could break.  SGD with
    momentum, whose update is linear in the gradient: Adam's first update
    of a leaf is about ``lr * sign(g)``, so on a finetuned encoder's
    near-zero gradients it turns summation-order noise into lr-sized steps
    (ROADMAP.md §3, the ill-conditioned encoder update)."""
    d = dict(dropout=0.3, embedding_dropout=0.2, encoder_finetune_after=1,
             encoder_lr=1e-2, decoder_lr=1e-2, embedding_lr=1e-2, opt="sgd",
             momentum=0.9, grad_clip="norm", clip_value=0.5, label_smoothing=0.1,
             decoder_tf="always")
    d.update(kw)
    return tiny_cfg(**d)


def make_batch(seed: int = 0, b: int = 8):
    """make_setup's batch: uint8 images, captions with <START>, lengths."""
    rng = np.random.default_rng(seed)
    batch = {"images": rng.integers(0, 256, (b, S, S, 3)).astype(np.uint8),
             "captions": rng.integers(1, V - 4, (b, R, T)).astype(np.int32),
             "lengths": rng.integers(2, T - 1, (b, R)).astype(np.int32)}
    batch["captions"][:, :, 0] = V - 2
    return batch


NO_AUGMENT = dict(aug_scale=1.0, aug_hflip=0.0, aug_noise_std=0.0)


def recompose(batch, ranks: int, chunk: int):
    """The one-process batch whose microbatch chunk i is every rank's chunk
    i of ``chunk`` rows, in rank order (the mesh's chunk composition)."""
    b = len(batch["lengths"])
    local = b // ranks
    order = [r * local + i * chunk + j for i in range(local // chunk)
             for r in range(ranks) for j in range(chunk)]
    return {k: v[order] for k, v in batch.items()}


def card_model(dev):
    """A seeded tiny_cfg model on ``dev`` (the card test's)."""
    from sat_tpu_torch.models.model import SATModel
    return SATModel.create(tiny_cfg(), torch.Generator(dev).manual_seed(0))


def step_and_beam(model, batch, mesh=ONE_RANK):
    """make_setup's gradient (dropout off, epsilon 1) and a beam decode
    (beamk 3, LN, ``fused=None``) of ``batch``'s rows (this rank's on a
    mesh), with the step kernels' calls.  Returns (loss, gradients by name,
    tokens, scores), the gradients summed over the mesh and the decode
    gathered."""
    from sat_tpu_torch.decode.beam import beam_search
    from sat_tpu_torch.kernels import decoder_step as KS
    from sat_tpu_torch.models.sat import train_forward_loss_grouped
    dev = next(model.parameters()).device
    model.decoder.requires_grad_(True)
    rows = {k: torch.from_numpy(mesh.rows(v)).to(dev) for k, v in batch.items()}
    x = rows["images"].float() / 255.0
    m = train_forward_loss_grouped(model.decoder, model.cfg, model.encode(x, train=True, mesh=mesh),
                                   rows["captions"], rows["lengths"], 1.0, None, mesh)
    m["loss"].backward()
    mesh.reduce_gradients(model.named_parameters(), mesh.vocab_sharded(V))
    KS.launches = 0
    r = beam_search(model.decoder, model.cfg, model.encode(x), beamk=3, max_gen_length=5,
                    rescore_method="LN", mesh=mesh)
    return {"loss": float(mesh.sum(m["loss"].detach())), "coords": mesh.coords,
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
            "tokens": mesh.fetch_global(r.tokens).cpu(),
            "scores": mesh.fetch_global(r.scores).cpu(), "launches": KS.launches}


def run_steps(trainer, batches):
    """Train steps; returns the losses and the weights and statistics."""
    losses = [{k: float(v) for k, v in trainer.train_step(b).items()} for b in batches]
    return losses, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


# --- jobs -------------------------------------------------------------------

def _model(ctx, mesh):
    from sat_tpu_torch.parallel.mesh import shard_vocab_params
    from sat_tpu_torch.train.checkpoints import load_model_from_checkpoint
    model, _ = load_model_from_checkpoint(ctx["ckpt"], device="cpu")
    if mesh.vocab_sharded(model.cfg.vocab_size):
        shard_vocab_params(model.decoder, mesh)
    return model


def _meshes(world):
    from sat_tpu_torch.parallel.mesh import create_mesh
    if world == 2:
        return {"dp": create_mesh((2,), ("data",)),
                "tp": create_mesh((1, 2), ("data", "model"))}
    return {"tp": create_mesh((2, 2), ("data", "model"))}


def job_grads(ctx, world):
    """make_setup's gradient on each mesh (dropout off, epsilon 1): this
    rank's gradients after the mesh's reduction, and the global loss."""
    from sat_tpu_torch.models.sat import train_forward_loss_grouped
    batch = {k: np.asarray(v) for k, v in np.load(ctx["batch"]).items()}
    out = {}
    for tag, mesh in _meshes(world).items():
        model = _model(ctx, mesh)
        model.decoder.requires_grad_(True)
        rows = {k: torch.from_numpy(mesh.rows(v)) for k, v in batch.items()}
        annots = model.encode(rows["images"].float() / 255.0, train=True, mesh=mesh)
        m = train_forward_loss_grouped(model.decoder, model.cfg, annots,
                                       rows["captions"], rows["lengths"], 1.0,
                                       None, mesh)
        m["loss"].backward()
        sharded = mesh.vocab_sharded(V)
        mesh.reduce_gradients(model.named_parameters(), sharded)
        out[tag] = {"loss": float(mesh.sum(m["loss"].detach())),
                    "coords": mesh.coords,
                    "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}}
    return out


def job_beam(ctx, world):
    """Beam search (plain path and the step kernels' path) and greedy of
    this rank's rows on each mesh, gathered to the global batch; a tree
    replicated from rank 0."""
    from sat_tpu_torch.decode.beam import beam_search, greedy_decode
    from sat_tpu_torch.parallel.mesh import replicate_tree
    batch = np.load(ctx["batch"])
    out = {}
    for tag, mesh in _meshes(world).items():
        model = _model(ctx, mesh)
        x = torch.from_numpy(mesh.rows(batch["images"])).float() / 255.0
        annots = model.encode(x)
        res = {}
        for fused in (False, True):
            r = beam_search(model.decoder, model.cfg, annots, beamk=3, max_gen_length=5,
                            rescore_method="LN", fused=fused, mesh=mesh)
            res[f"beam_{fused}"] = (mesh.fetch_global(r.tokens), mesh.fetch_global(r.scores))
        g = greedy_decode(model.decoder, model.cfg, annots, max_gen_length=5,
                          fused=True, early_exit=True, mesh=mesh)
        res["greedy"] = (mesh.fetch_global(g.tokens), mesh.fetch_global(g.scores))
        res["replicated"] = replicate_tree(
            {"x": torch.full((2,), float(mesh.rank)), "y": np.full(3, mesh.rank)}, mesh)
        res["table_rows"] = model.decoder.embedding.shape[0]
        res["out_cols"] = model.decoder.out_proj.w.shape[1]
        out[tag] = res
    return out


ADAM_TP = dict(opt="adam", encoder_finetune_after=-1, mesh_shape=(1, 2),
               mesh_axes=("data", "model"))


def job_trainer(ctx, world):
    """Three Trainer steps on the global batch's rows: DP, vocab TP, vocab
    TP under Adam (its moments' slices; its checkpoint, written by rank 0),
    then DP microbatch chunks without the augment."""
    from sat_tpu_torch.parallel.mesh import shard_batch
    from sat_tpu_torch.train.checkpoints import save_checkpoint
    from sat_tpu_torch.train.loop import Trainer
    batches = [make_batch(s) for s in (1, 2, 3)]
    out = {}
    for tag, kw in (("dp", dict(mesh_shape=(2,))),
                    ("tp", dict(mesh_shape=(1, 2), mesh_axes=("data", "model"))),
                    ("tp_adam", ADAM_TP)):
        tr = Trainer(trainer_cfg(**kw), device="cpu", steps_per_epoch=10)
        mesh = tr.mesh
        losses, state = run_steps(tr, [shard_batch(b, mesh) for b in batches])
        out[tag] = {"losses": losses, "state": state}
        if tag == "tp_adam":
            emb = tr.model.decoder.embedding
            out[tag]["moments"] = {k: tuple(v.shape)
                                   for k, v in tr.optimizer.state[emb].items() if v.ndim}
            tree = tr._checkpoint_tree()
            if tr.is_main:
                save_checkpoint(ctx["tp_ckpt"], tr.cfg, tree)
    tr = Trainer(trainer_cfg(microbatch=4, **NO_AUGMENT), device="cpu",
                 steps_per_epoch=10)
    out["micro"] = dict(zip(("losses", "state"), run_steps(
        tr, [shard_batch(b, tr.mesh) for b in batches[:2]])))
    return out


def job_fit(ctx, world):
    """Trainer.fit over the dataset on a mesh of every rank."""
    from sat_tpu_torch.train.loop import Trainer
    cfg = SATConfig(**dict(ctx["fit_kw"], mesh_shape=(world,)))
    tr = Trainer(cfg, log_root=ctx["log_root"], device="cpu")
    metrics = tr.fit()
    return {"metrics": metrics, "logdir": tr.logdir, "is_main": tr.is_main,
            "writes": (tr.logger.enabled, tr.ckpt.write, tr.restart_ckpt.write),
            "val_batch": tr.val_loader.batch_size}


def job_serve(ctx, world):
    """serve on the mesh: beam at f32, multinomial sampling, vocab TP."""
    from sat_tpu_torch import serve
    for name, extra in ctx["serve_runs"].items():
        serve.main(ctx["serve_argv"] + extra + ["--output", ctx["serve_out"][name]],
                   device="cpu")
    return {}


def job_card(ctx, world):
    """On the card that both ranks share: a DP and a vocab TP step and
    beam decode (tests/test_torch_cuda_kernels.py)."""
    from sat_tpu_torch.parallel.mesh import shard_vocab_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, out = torch.device("cuda:0"), {}
    for tag, mesh in _meshes(world).items():
        model = card_model(dev)
        if mesh.vocab_sharded(V):
            shard_vocab_params(model.decoder, mesh)
        out[tag] = step_and_beam(model, make_batch(0), mesh)
    return out


def job_wire(ctx, world):
    """The collectives of a DP ``validate()``, a TP step and its
    checkpoint tree (``gather_tree`` of numpy leaves), and
    ``replicate_tree``, as a backend without a host side (NCCL) takes
    them: with ``mesh._gloo`` made False, each tensor handed to
    ``torch.distributed`` must be one that ``mesh._wire`` returned (which
    puts it on ``_comm_device``; here the host stands in for the card).
    Returns, per phase, each call's name and whether its tensor was."""
    import torch.distributed as dist
    from sat_tpu_torch.parallel import mesh as M
    from sat_tpu_torch.parallel.mesh import replicate_tree, shard_batch
    from sat_tpu_torch.train.loop import Trainer
    wired, calls, real = set(), [], {}

    def wire(x, group, copy=False):
        y = real["_wire"](x, group, copy)
        wired.add(y.untyped_storage().data_ptr())
        return y

    def checked(name, pos):
        def run(*args, **kw):
            t = args[pos]
            calls.append((name, t.untyped_storage().data_ptr() in wired))
            return real[name](*args, **kw)
        return run

    patched = {(M, "_gloo"): lambda group: False,
               (M, "_comm_device"): lambda group: torch.device("cpu"),
               (M, "_wire"): wire}
    patched.update({(dist, name): checked(name, pos) for name, pos in
                    (("all_reduce", 0), ("broadcast", 0),
                     ("all_gather_into_tensor", 1), ("all_gather", 1))})
    for (mod, name), fn in patched.items():
        real[name] = getattr(mod, name)
        setattr(mod, name, fn)
    out = {}
    try:
        cfg = SATConfig(**dict(ctx["fit_kw"], mesh_shape=(world,)))
        tr = Trainer(cfg, log_root=os.path.join(ctx["out"], "wire_logs"), device="cpu")
        out["metrics"] = tr.validate()
        out["validate"], calls[:] = list(calls), []
        tr = Trainer(trainer_cfg(**ADAM_TP), device="cpu", steps_per_epoch=10)
        tr.train_step(shard_batch(make_batch(1), tr.mesh))
        out["tp_step"], calls[:] = list(calls), []
        tree = tr._checkpoint_tree()
        out["gather_tree"], calls[:] = list(calls), []
        out["table"] = np.shape(tree["params"]["decoder"]["embedding"])
        replicate_tree({"x": torch.full((2,), float(tr.mesh.rank)),
                        "y": np.full(3, tr.mesh.rank)}, tr.mesh)
        out["replicate_tree"] = list(calls)
    finally:
        for (mod, name) in patched:
            setattr(mod, name, real[name])
    return out


def job_torchrun(ctx, world):
    """The process group from torchrun's variables."""
    import torch.distributed as dist
    from sat_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "mesh": (mesh.shape, mesh.size)}


GROUPS = {"pair": ("grads", "beam", "trainer", "serve", "fit", "wire"),
          "quad": ("grads", "beam"), "torchrun": ("torchrun",), "card": ("card",)}


def main(argv):
    group, rank, world, init_file, ctx_path = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    ctx = json.load(open(ctx_path))
    import torch.distributed as dist
    if group == "torchrun":
        from sat_tpu_torch.parallel.mesh import maybe_initialize_distributed
        assert maybe_initialize_distributed()
    else:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
    try:
        for job in GROUPS[group]:
            res = globals()[f"job_{job}"](ctx, world)
            torch.save(res, os.path.join(ctx["out"], f"{group}_{job}_rank{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
