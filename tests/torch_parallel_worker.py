"""One rank of a data- (and tensor-) parallel agrl_torch job on the CPU
(gloo), for the tests/test_torch_parallel*.py files, which start `world`
of these and hold what they write against agrl_tpu's single-device
functions on the global batch. It imports no JAX: torch, numpy and
agrl_torch only.

    python tests/torch_parallel_worker.py MODE RANK WORLD PORT IN OUT [MP]

IN is a torch.save'd dict of the global inputs (made by the test from a
numpy seed); OUT receives this rank's results; MP (default 1) is the
mesh's mp axis, dp = WORLD / MP. Modes:
  * ops: global-batch BatchNorm of each kind (with and without
    frozen_running_stats) and the gathered batch-hard mining (of a global
    batch of 8 and of 320);
  * train: two data-parallel train steps of vmgn_tiny;
  * eval: the mesh Evaluator under evenly, dense and all on in-memory
    loaders, and the host-scored distance matrix;
  * mp: vmgn_tiny placed over the mp axis (parallel.place_state at the
    input's min_size): each optimizer's state placed, two train steps,
    the gathered state, the mp Evaluator and a FeatureExtractor on the
    placed model, a gathered checkpoint written (sync and async) and
    resumed, an agrl_tpu .msgpack resumed.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from agrl_torch.parallel import initialize_distributed, make_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BN_KINDS = {  # class name -> input shape of the global batch
    "BatchNorm1d": (8, 6),
    "BatchNorm1d_rows": (8, 6, 5),
    "BatchNorm2d": (8, 6, 5, 3),
    "BatchNorm3d": (8, 6, 2, 5, 3),
}


def _slice(a, mesh):
    k = a.shape[0] // mesh.dp
    return a[mesh.dp_index * k:(mesh.dp_index + 1) * k]


def run_ops(inp, mesh):
    from agrl_torch.losses import batch_hard_triplet_heads
    from agrl_torch.models import backbone
    from agrl_torch.parallel import average_gradients

    out = {}
    for kind in BN_KINDS:
        for frozen in (False, True):
            bn = getattr(backbone, kind.split("_")[0])(6, eps=1e-5)
            bn.load_state_dict(inp["bn_state"])
            bn.train()
            x = _slice(inp[f"x_{kind}"], mesh).clone().requires_grad_(True)
            g = _slice(inp[f"g_{kind}"], mesh)
            ctx = backbone.frozen_running_stats() if frozen else torch.enable_grad()
            with backbone.global_batch_stats(mesh), ctx:
                y = bn(x)
            (y * g).sum().backward()
            out[f"{kind}/{frozen}"] = dict(
                y=y.detach(), dx=x.grad, dw=bn.weight.grad, db=bn.bias.grad,
                running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone(),
                tracked=int(bn.num_batches_tracked))

    # the mining: each rank's heads (H, b, D) from its rows through a shared
    # projection P, the loss on the gathered batch, P's gradient averaged;
    # and of a long global batch (K3's long schedule on the card)
    def mined(feats, labels):
        feats = _slice(feats.transpose(0, 1), mesh).transpose(0, 1)
        heads = [f.clone().requires_grad_(True) for f in feats]
        loss = batch_hard_triplet_heads(heads, _slice(labels, mesh), mesh=mesh)
        loss.backward()
        return loss.detach(), torch.stack([h.grad for h in heads])

    out["mining_long"] = dict(zip(("loss", "grads"), mined(inp["feats_long"],
                                                            inp["labels_long"])))
    feats, labels = _slice(inp["feats"].transpose(0, 1), mesh).transpose(0, 1), _slice(
        inp["labels"], mesh)
    heads = [f.clone().requires_grad_(True) for f in feats]
    loss = batch_hard_triplet_heads(heads, labels, mesh=mesh)
    loss.backward()
    proj = torch.nn.Linear(inp["rows"].shape[1], feats.shape[2], bias=False)
    proj.weight.data.copy_(inp["proj"])
    rows = _slice(inp["rows"], mesh)
    H = feats.shape[0]
    batch_hard_triplet_heads([proj(rows) * (h + 1) for h in range(H)], labels,
                             mesh=mesh).backward()
    average_gradients(proj.parameters(), mesh)
    out["mining"] = dict(loss=loss.detach(), grads=torch.stack([h.grad for h in heads]),
                         proj_grad=proj.weight.grad)
    return out


def run_train(inp, mesh):
    from agrl_torch.engine.trainer import make_train_step
    from agrl_torch.models import build_model
    from agrl_torch.optim import init_optim
    from agrl_torch.parallel import replicated

    model = build_model("vmgn_tiny", num_classes=inp["num_classes"], consistent_loss=True)
    if mesh.rank == 0:  # the other ranks take rank 0's weights from `replicated`
        model.load_state_dict(inp["state"])
    opt = init_optim(inp["optim"], model.parameters(), inp["lr"], weight_decay=5e-4)
    replicated(mesh, model, opt)
    step = make_train_step(model, opt, lambda s: inp["lr"], label_smooth=False,
                           aug={"flip_aug": True}, mesh=mesh)
    history = []
    for imgs, pids, adj, flip, subclips in inp["steps"]:
        metrics = step(_slice(imgs, mesh), _slice(pids, mesh), _slice(adj, mesh), flip=flip,
                       subclip_indices=subclips)
        history.append({k: float(v) for k, v in metrics.items()})
    # and with the generator: the draws of the global batch, this rank's slice
    gen_model = build_model("vmgn_tiny", num_classes=inp["num_classes"], consistent_loss=True)
    gen_model.load_state_dict(inp["state"])
    gen_opt = init_optim(inp["optim"], gen_model.parameters(), inp["lr"], weight_decay=5e-4)
    gen_step = make_train_step(gen_model, gen_opt, lambda s: inp["lr"], label_smooth=False,
                               aug={"flip_aug": True, "rand_erase": True}, mesh=mesh)
    imgs, pids, adj = inp["steps"][0][:3]
    gen_metrics = gen_step(_slice(imgs, mesh), _slice(pids, mesh), _slice(adj, mesh),
                           generator=torch.Generator().manual_seed(inp["seed"]))
    return dict(history=history, state={k: v.clone() for k, v in model.state_dict().items()},
                generator_metrics={k: float(v) for k, v in gen_metrics.items()},
                generator_state={k: v.clone() for k, v in gen_model.state_dict().items()})


def run_eval(inp, mesh):
    import contextlib
    import io

    from agrl_torch.engine.evaluator import Evaluator
    from agrl_torch.models import build_model

    model = build_model("vmgn_tiny", num_classes=inp["num_classes"])
    model.load_state_dict(inp["state"])
    out = {}
    for sample, (query, gallery) in inp["loaders"].items():
        ev = Evaluator(model, test_sample=sample, clip_batch=inp["clip_batch"], device="cpu")
        console = io.StringIO()
        with contextlib.redirect_stdout(console):
            qf = ev.extract(query, "query", mesh=mesh)[0]
            gf = ev.extract(gallery, "gallery", mesh=mesh)[0]
            r1, mAP = ev.evaluate(query, gallery, dist_metric="euclidean", mesh=mesh)
            distmat = ev.evaluate(query, gallery, dist_metric="euclidean", return_distmat=True,
                                  mesh=mesh)
        out[sample] = dict(qf=torch.as_tensor(qf).cpu(), gf=torch.as_tensor(gf).cpu(),
                           rank1=r1, mAP=mAP, distmat=distmat, console=console.getvalue())
    return out


def _digests(model) -> dict:
    """{name: sha1 of the bytes} of every parameter and buffer: equal
    digests across ranks are bit-equal tensors."""
    import hashlib

    return {k: hashlib.sha1(v.detach().contiguous().numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def _mp_model(inp, state):
    from agrl_torch.models import build_model

    model = build_model("vmgn_tiny", num_classes=inp["num_classes"], consistent_loss=True)
    model.load_state_dict(state)
    return model


def _mp_step(model, opt, inp, mesh):
    from agrl_torch.engine.trainer import make_train_step

    return make_train_step(model, opt, lambda s: inp["lr"], label_smooth=False,
                           aug={"flip_aug": True}, mesh=mesh, start_step=inp.get("start", 0))


def _run_steps(step, steps, mesh):
    return [{k: float(v) for k, v in step(_slice(imgs, mesh), _slice(pids, mesh),
                                          _slice(adj, mesh), flip=flip,
                                          subclip_indices=subclips).items()}
            for imgs, pids, adj, flip, subclips in steps]


def run_mp(inp, mesh):
    import torch.distributed as dist

    from agrl_torch.core.checkpoint import (
        AsyncCheckpointer,
        fetch_global_state,
        load_checkpoint,
        save_checkpoint,
    )
    from agrl_torch.core.flax_msgpack import read_checkpoint
    from agrl_torch.core.optax_state import load_optax_state
    from agrl_torch.models.weight_convert import from_jax_variables
    from agrl_torch.optim import OPTIMIZER_NAMES, init_optim
    from agrl_torch.parallel import place_state, sharded_weights

    min_size = inp["min_size"]
    out = {"mesh": (mesh.dp, mesh.mp, mesh.dp_index, mesh.mp_index)}

    # each optimizer's state, made by one whole update on this rank alone,
    # then placed: every tensor of a sharded weight's shape is its block
    placed = {}
    for name in OPTIMIZER_NAMES if "place" in inp["parts"] else ():
        model = _mp_model(inp, inp["state"])
        opt = init_optim(name, model.parameters(), inp["lr"], weight_decay=5e-4)
        gen = torch.Generator().manual_seed(0)
        for p in model.parameters():
            if p.requires_grad:
                p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        params = dict(model.named_parameters())
        whole = {n: dict(opt.state[p]) for n, p in params.items()}
        plan = place_state(mesh, model, opt, min_size=min_size)
        params = dict(model.named_parameters())
        specs = sharded_weights(model)
        shapes, equal = {}, True
        for n in plan:
            state = opt.state[params[n]]
            shapes[n] = {k: tuple(v.shape) for k, v in state.items() if torch.is_tensor(v)}
            for k, v in whole[n].items():
                if torch.is_tensor(v) and v.dim() == 2:
                    equal &= torch.equal(state[k], specs[n].take(v))
        in_optimizer = {id(p) for g in opt.param_groups for p in g["params"]}
        placed[name] = dict(plan=plan, shapes=shapes, blocks_equal=bool(equal),
                            params_in_optimizer=all(id(params[n]) in in_optimizer for n in plan),
                            param_shapes={n: tuple(params[n].shape) for n in plan})
    out["placed"] = placed

    # two train steps of the placed model (SGD, injected draws)
    model = _mp_model(inp, inp["state"])
    opt = init_optim(inp["optim"], model.parameters(), inp["lr"], weight_decay=5e-4)
    out["plan"] = place_state(mesh, model, opt, min_size=min_size)
    out["history"] = _run_steps(_mp_step(model, opt, inp, mesh), inp["steps"], mesh)
    out["digests"] = _digests(model)
    state = fetch_global_state(model, opt, fetch_local=mesh.rank == 0)
    out["state"] = None if state is None else state["state_dict"]
    if "eval" in inp["parts"]:
        out["eval"] = run_mp_eval(inp, mesh)
    if "ckpt" not in inp["parts"]:
        return out

    # a gathered checkpoint, sync and async, then resumed into a fresh
    # model placed anew; the step after it against the live model's
    ckpt, ckpt_async = inp["ckpt"], inp["ckpt"].replace(".pth.tar", "_async.pth.tar")
    if mesh.rank == 0:
        save_checkpoint(model, opt, ckpt, 1, rank1=0.5, mAP=0.25, state=state)
        writer = AsyncCheckpointer()
        writer.save(model, opt, ckpt_async, 1, rank1=0.5, mAP=0.25, state=state)
        writer.close()
    dist.barrier()
    resumed = _mp_model(inp, inp["state"])
    resumed_opt = init_optim(inp["optim"], resumed.parameters(), inp["lr"], weight_decay=5e-4)
    out["meta"] = load_checkpoint(ckpt, resumed, resumed_opt)
    place_state(mesh, resumed, resumed_opt, min_size=min_size)
    nxt = dict(inp, start=len(inp["steps"]))
    out["next_live"] = _run_steps(_mp_step(model, opt, nxt, mesh), inp["next"], mesh)
    out["next_resumed"] = _run_steps(_mp_step(resumed, resumed_opt, nxt, mesh), inp["next"],
                                     mesh)
    out["next_digests"] = (_digests(model), _digests(resumed))

    # agrl_tpu's .msgpack with its optax state, resumed under the mesh
    tree, _ = read_checkpoint(inp["msgpack"])
    jmodel = _mp_model(inp, inp["state"])
    from_jax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}, jmodel)
    jopt = init_optim(inp["optim"], jmodel.parameters(), inp["lr"], weight_decay=5e-4)
    count = load_optax_state(jopt, jmodel, tree["opt_state"], inp["optim"])
    place_state(mesh, jmodel, jopt, min_size=min_size)
    out["msgpack_next"] = _run_steps(_mp_step(jmodel, jopt, dict(inp, start=count), mesh),
                                     inp["next"], mesh)
    jstate = fetch_global_state(jmodel, jopt, fetch_local=mesh.rank == 0)
    out["msgpack_state"] = None if jstate is None else jstate["state_dict"]
    return out


def run_mp_eval(inp, mesh):
    """The mp Evaluator's features of the initial weights, placed."""
    import contextlib
    import io

    from agrl_torch.engine.evaluator import Evaluator
    from agrl_torch.parallel import place_state, sharded_weights

    model = _mp_model(inp, inp["state"])
    place_state(mesh, model, min_size=inp["min_size"])
    before = {n: getattr(model.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2])
              for n in sharded_weights(model)}
    out = {}
    for sample, (query, gallery) in inp["loaders"].items():
        ev = Evaluator(model, test_sample=sample, clip_batch=inp["clip_batch"], device="cpu")
        with contextlib.redirect_stdout(io.StringIO()):
            r1, mAP = ev.evaluate(query, gallery, dist_metric="euclidean", mesh=mesh)
            qf = ev.extract(query, "query", mesh=mesh)[0]
        out[sample] = dict(qf=qf.cpu(), rank1=r1, mAP=mAP)
    # the blocks are back in place after each evaluation
    out["blocks_restored"] = sharded_weights(model).keys() == before.keys() and all(
        getattr(model.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2]) is t
        for n, t in before.items())
    # serving: a FeatureExtractor on the placed model (every rank builds
    # one: it gathers the blocks whole at construction), the model keeps
    # its blocks
    from agrl_torch.engine.export import FeatureExtractor

    for p in model.parameters():  # gradients, as a model in training holds them
        p.grad = torch.ones_like(p)
    fx = FeatureExtractor(model, batch_size=inp["fx_batch"], seq_len=inp["fx_imgs"].shape[1],
                          bf16=False, device="cpu")
    out["fx"] = fx(inp["fx_imgs"], inp["fx_adjs"])
    out["fx_blocks_kept"] = sharded_weights(model).keys() == before.keys() and all(
        getattr(model.get_submodule(n.rpartition(".")[0]), n.rpartition(".")[2]) is t
        for n, t in before.items())
    # it serves a snapshot: weights only (the model's gradients stay with the
    # model), and a later change of the model's weights does not reach it
    out["fx_model_has_grads"] = any(p.grad is not None for p in model.parameters())
    out["fx_snapshot_has_grads"] = any(p.grad is not None for p in fx.model.parameters())
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    out["fx_after_model_change"] = fx(inp["fx_imgs"], inp["fx_adjs"])
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, inputs: dict, tmp_path, world: int = 2, timeout: float = 240.0,
          mp: int = 1):
    """Runs `world` ranks of this script in `mode` on `inputs` (in the
    calling test's process) over a dp x mp mesh, dp = world / mp; returns
    each rank's results, rank order."""
    import subprocess

    inp = str(tmp_path / f"{mode}_in.pt")
    torch.save(inputs, inp)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"{mode}_rank{r}.pt") for r in range(world)]
    logs = [open(tmp_path / f"{mode}_rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(world), str(port), inp, outs[r], str(mp)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(codes):
        text = "\n".join((tmp_path / f"{mode}_rank{r}.log").read_text()[-3000:]
                         for r in range(world))
        raise AssertionError(f"ranks of {mode} exited {codes}:\n{text}")
    return [torch.load(o, weights_only=False) for o in outs]


def main():
    torch.set_num_threads(1)
    mode, rank, world, port, inp_path, out_path = sys.argv[1:7]
    mp = int(sys.argv[7]) if len(sys.argv) > 7 else 1
    initialize_distributed(f"127.0.0.1:{port}", int(world), int(rank), device="cpu")
    try:
        mesh = make_mesh(mp=mp)
        inp = torch.load(inp_path, weights_only=False)
        modes = {"ops": run_ops, "train": run_train, "eval": run_eval, "mp": run_mp}
        result = modes[mode](inp, mesh)
        torch.save(result, out_path)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
