"""The port's step programs (`stratanet2_tpu_torch/learning/programs.py`,
the counterpart of the JAX package's jitted steps, `lax.scan` epoch and
eval, and `_PROGRAM_CACHE`) and the two changes they need, on the CPU:
BatchNorm's running statistics written in place, and Adam's state and
learning rate restored into the tensors an optimizer already holds.

There is no CUDA graph here, so the bookkeeping runs with `StandInGraphs`,
a stand-in of `programs.CudaGraphs`' interface: a capture runs the body's
Python, as a real capture does, and then puts back every tensor the
program holds (a real capture runs no kernel); a replay runs the body again
and leaves the launch counts alone (a real replay runs no Python), writing
into the captured outputs. The steps on the card are held to their eager
bodies bit for bit by `chip_smoke.py`'s "graphs" phase.

Tolerances: none. Every comparison is bit for bit (the same operations on
the same inputs, eagerly and through a program)."""

import copy
from dataclasses import replace

import numpy as np
import pytest
import torch

from stratanet2_tpu_torch.config import default_config
from stratanet2_tpu_torch.data import device_dataset as D
from stratanet2_tpu_torch.inference import predict
from stratanet2_tpu_torch.learning import programs, train
from stratanet2_tpu_torch.learning.kde import fit_kde_mixture, fit_kde_mixture_from_dataset
from stratanet2_tpu_torch.models.nn import BN_MOMENTUM, BatchNorm
from stratanet2_tpu_torch.ops import cuda_kernels as ck
from stratanet2_tpu_torch.utils import checkpoint as ckpt
from stratanet2_tpu_torch.utils.synthetic import random_model, serve_batch, train_batch
from synthetic import make_plot_dataset

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _tree_copy(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _tree_copy(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _tree_copy(d, s)


class StandInGraphs:
    """`programs.CudaGraphs`' interface on the CPU (see the module doc).
    `program` is the StepProgram it serves, whose held tensors a capture
    puts back."""

    def __init__(self):
        self.program = None
        self.calls = []

    def run(self, fn, device):
        self.calls.append("run")
        return fn()

    def capture(self, fn, device, generator):
        self.calls.append("capture")
        held = self.program.held if self.program is not None else ()
        saved = [t.detach().clone() for t in held]
        out = fn()
        with torch.inference_mode():
            for t, s in zip(held, saved):
                t.copy_(s)
        return (fn, out), out

    def replay(self, handle):
        self.calls.append("replay")
        fn, out = handle
        counts = ck.launch_snapshot()
        new = fn()
        ck.LAUNCHES.update(counts[0])
        ck.PATH_LAUNCHES.update(counts[1])
        with torch.inference_mode():
            _tree_copy(out, new)


def stand_in(program):
    """Serve `program` (a step's `.program`) with a StandInGraphs."""
    program.graphs = StandInGraphs()
    program.graphs.program = program
    return program.graphs


@pytest.fixture
def on_graphs(monkeypatch):
    """The step factories build programs on the CPU, as on the card."""
    for module in (train, predict, D):
        monkeypatch.setattr(module, "graphed", lambda device, group=None: group is None)
    ck.reset_launches()
    yield
    ck.reset_launches()


def tiny_cfg(**train_kw):
    cfg = default_config("DEV")
    return replace(cfg, model=replace(cfg.model, subsample_size=256, k1=8, k2=16),
                   train=replace(cfg.train, batch_size=3, **train_kw))


def _bits(t):
    return t.detach().contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(a, b, what):
    assert torch.equal(_bits(a), _bits(b)), what


# ---------------------------------------------------------------------------
# BatchNorm in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_bn_running_stats_are_written_in_place_bit_for_bit(masked):
    """A train-mode forward writes the running statistics into the buffers
    it holds (same tensors, same storage), equal bit for bit to the
    rebinding formula it replaces."""
    torch.manual_seed(0)
    bn = BatchNorm(6).train()
    bn.mean.copy_(torch.randn(6) * 0.1)
    bn.var.copy_(torch.rand(6) + 0.5)
    x = torch.randn(2, 7, 6)
    mask = torch.rand(2, 7) > 0.3 if masked else None
    ids = [(id(t), t.data_ptr()) for t in (bn.mean, bn.var)]
    mean0, var0 = bn.mean.clone(), bn.var.clone()
    bn(x, mask)
    assert [(id(t), t.data_ptr()) for t in (bn.mean, bn.var)] == ids
    m = torch.ones(2, 7) if mask is None else mask.float()
    n = m.sum().clamp_min(1.0)
    xc = x - mean0
    dsum, sqsum = (xc * m[..., None]).sum((0, 1)), (xc * xc * m[..., None]).sum((0, 1))
    if mask is None:
        n = x.new_full((), 14.0)
        dsum, sqsum = xc.sum((0, 1)), (xc * xc).sum((0, 1))
    dmean = dsum / n
    var = torch.maximum(sqsum / n - dmean * dmean, x.new_zeros(()))
    unbiased = var * n / (n - 1.0).clamp_min(1.0)
    assert_bitwise(bn.mean, (1 - BN_MOMENTUM) * mean0 + BN_MOMENTUM * (dmean + mean0), "mean")
    assert_bitwise(bn.var, (1 - BN_MOMENTUM) * var0 + BN_MOMENTUM * unbiased, "var")


def test_a_train_step_keeps_every_buffer_of_the_model():
    """A whole train step (the fused SA route's BN updates among them)
    moves every BN buffer without rebinding one."""
    cfg = tiny_cfg()
    cloud, xyz, gt = train_batch(3, 256, torch.Generator().manual_seed(0), CPU)
    model = random_model(cfg.model, 0, CPU, running_stats=False)
    opt, sched = train.make_optimizer(cfg, model, 5)
    before = {k: (id(b), b.data_ptr(), b.clone()) for k, b in model.named_buffers()}
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).numpy())
    train.make_train_step(cfg, kde, device="cpu")(model, opt, sched, cloud, xyz, gt)
    for k, b in model.named_buffers():
        assert (id(b), b.data_ptr()) == before[k][:2], k
        assert not torch.equal(b, before[k][2]), f"{k} did not move"


# ---------------------------------------------------------------------------
# Adam: the CPU's float learning rate, and load_adam_state into held tensors
# ---------------------------------------------------------------------------


def test_make_optimizer_on_the_cpu_keeps_a_float_lr():
    cfg = tiny_cfg()
    opt, _ = train.make_optimizer(cfg, random_model(cfg.model, 0, CPU), 5)
    assert isinstance(opt.param_groups[0]["lr"], float) and not opt.param_groups[0]["capturable"]


def _stepped(cfg, steps=2):
    cloud, xyz, gt = train_batch(3, 256, torch.Generator().manual_seed(1), CPU)
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).numpy())
    model = random_model(cfg.model, 0, CPU, running_stats=False)
    opt, sched = train.make_optimizer(cfg, model, 1)
    step = train.make_train_step(cfg, kde, device="cpu")
    for _ in range(steps):
        step(model, opt, sched, cloud, xyz, gt)
    return model, opt, sched


def _state_leaves(opt_state):
    _, (count, mu, nu), (sched,) = opt_state
    flat = {}
    for name, tree in (("mu", mu), ("nu", nu)):
        for k, v in ckpt._flatten(tree).items():
            flat[f"{name}.{k}"] = np.asarray(v)
    return int(count), int(sched), flat


def test_load_adam_state_writes_into_the_state_held():
    """Into an optimizer that holds state, every state tensor keeps its
    identity and storage; adam_state -> load_adam_state -> adam_state is
    equal; a checkpoint of other values is read into those tensors."""
    cfg = tiny_cfg(step_size=1)
    model, opt, sched = _stepped(cfg)
    held = {id(p): [(id(v), v.data_ptr()) for v in opt.state[p].values()]
            for p in model.parameters()}
    saved = ckpt.adam_state(model, opt, sched)
    other_model, other_opt, other_sched = _stepped(cfg, steps=3)
    ckpt.load_adam_state(model, opt, sched, ckpt.adam_state(other_model, other_opt, other_sched))
    assert {id(p): [(id(v), v.data_ptr()) for v in opt.state[p].values()]
            for p in model.parameters()} == held
    assert _state_leaves(ckpt.adam_state(model, opt, sched))[:2] == (3, 3)
    ckpt.load_adam_state(model, opt, sched, saved)
    count, u, flat = _state_leaves(ckpt.adam_state(model, opt, sched))
    want = _state_leaves(saved)
    assert (count, u) == want[:2] == (2, 2)
    for k, v in want[2].items():
        assert np.array_equal(flat[k].view(np.uint32), v.view(np.uint32)), k
    assert opt.param_groups[0]["lr"] == cfg.train.lr * cfg.train.lr_decay ** 2


def test_load_adam_state_fills_a_tensor_lr_in_place():
    """A capturable Adam (the card's, with a tensor learning rate) keeps its
    learning-rate tensor, filled with the schedule's value past a staircase
    drop, and its new count goes to the parameter's device."""
    cfg = tiny_cfg(step_size=1)
    model, opt, sched = _stepped(cfg)
    saved = ckpt.adam_state(model, opt, sched)
    fresh = random_model(cfg.model, 0, CPU, running_stats=False)
    lr = torch.tensor(cfg.train.lr)
    topt = torch.optim.Adam(fresh.parameters(), lr=lr, weight_decay=cfg.train.wd,
                            capturable=True)
    tsched = torch.optim.lr_scheduler.LambdaLR(topt, lambda u: cfg.train.lr_decay ** u)
    ckpt.load_adam_state(fresh, topt, tsched, saved)
    assert topt.param_groups[0]["lr"] is lr
    assert float(lr) == float(torch.tensor(cfg.train.lr) * cfg.train.lr_decay ** 2)
    for p in fresh.parameters():
        assert topt.state[p]["step"].device == p.device and float(topt.state[p]["step"]) == 2.0


# ---------------------------------------------------------------------------
# StepProgram's bookkeeping
# ---------------------------------------------------------------------------


def _toy_program():
    """A body x * w + 1 that pretends to launch fps twice and the cluster
    path once, and counts its Python runs."""
    runs = []

    def body(w, x):
        runs.append(tuple(x.shape))
        ck.LAUNCHES["fps"] += 2
        ck.PATH_LAUNCHES["fps_cluster"] += 1
        return {"y": x * w + 1}

    program = programs.StepProgram(body)
    graphs = stand_in(program)
    return program, graphs, runs


def test_program_captures_once_a_shape_and_replays():
    ck.reset_launches()
    program, graphs, runs = _toy_program()
    w = torch.tensor([2.0])
    for n in (3, 3, 5, 3, 5):
        x = torch.arange(float(n))
        out = program((w,), (x,), lambda: (w,))
        assert torch.equal(out["y"], x * 2 + 1)
    assert graphs.calls == ["run", "capture", "replay", "run", "capture", "replay", "replay"]
    assert ck.graph_counts() == {"captures": 2, "replays": 3}
    # the launches the card ran: 5 steps, never the captures
    assert ck.launch_counts()["fps"] == 10 and ck.path_launch_counts()["fps_cluster"] == 5
    ck.reset_launches()


def test_program_recaptures_for_new_tensors_and_holds_one_set():
    """A replaced tensor, or a new optimizer, drops every graph of the
    program; one set of tensors is held at a time."""
    program, graphs, _ = _toy_program()
    w = torch.tensor([2.0])
    x3, x5 = torch.arange(3.0), torch.arange(5.0)
    program((w,), (x3,), lambda: (w,))
    program((w,), (x5,), lambda: (w,))
    assert len(program._graphs) == 2 and program.held == (w,)
    w2 = torch.tensor([3.0])  # a new tensor: every graph goes
    assert torch.equal(program((w2,), (x3,), lambda: (w2,))["y"], x3 * 3 + 1)
    assert len(program._graphs) == 1 and program.held == (w2,)
    assert graphs.calls.count("capture") == 3

    p = torch.nn.Parameter(torch.ones(2))
    opts = [torch.optim.Adam([p], lr=0.1) for _ in range(2)]

    def body(opt, x):
        opt.zero_grad(set_to_none=True)
        (p * x).sum().backward()
        opt.step()
        return p.detach() + 0

    prog = programs.StepProgram(body)
    graphs = stand_in(prog)
    for opt in (opts[0], opts[0], opts[1], opts[1]):
        prog((opt,), (torch.ones(2),), lambda: (p, *programs.optimizer_tensors(opt)),
             params=(p,))
    assert graphs.calls.count("capture") == 2 and graphs.calls.count("replay") == 2
    assert all(any(t is v for t in prog.held) for v in opts[1].state[p].values())


def test_outputs_survive_the_next_replay():
    program, _, _ = _toy_program()
    w = torch.tensor([2.0])
    outs = [program((w,), (torch.full((3,), float(i)),), lambda: (w,)) for i in range(4)]
    for i, out in enumerate(outs):
        assert torch.equal(out["y"], torch.full((3,), 2.0 * i + 1))
    assert len({out["y"].data_ptr() for out in outs}) == 4


def test_replayed_draws_equal_eager_draws():
    """The program's own generator takes the caller's state before a replay
    and gives it back after: the draws and the caller's generator end as
    eagerly."""
    def body(x, generator):
        return x + torch.rand(4, generator=generator)

    program = programs.StepProgram(body)
    stand_in(program)
    gen, ref = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for i in range(3):
        x = torch.full((4,), float(i))
        assert_bitwise(program((), (x,), lambda: (), generator=gen), body(x, ref), f"call {i}")
    assert torch.equal(gen.get_state(), ref.get_state())


def test_cpu_steps_run_eagerly(monkeypatch):
    """On the CPU the serve, train and eval steps and the device-resident
    epoch and eval run their bodies eagerly: no capture, no replay."""
    class NoGraphs:
        def __getattr__(self, name):
            raise AssertionError(f"a CPU step used the graphs' {name}")

    monkeypatch.setattr(programs, "CudaGraphs", NoGraphs)
    ck.reset_launches()
    cfg = tiny_cfg()
    cloud, xyz, gt = train_batch(3, 256, torch.Generator().manual_seed(2), CPU)
    model = random_model(cfg.model, 0, CPU, running_stats=False)
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).numpy())
    serve = predict.make_predict_step(cfg, device="cpu")
    step = train.make_train_step(cfg, kde, device="cpu")
    assert serve.program is None and step.program is None
    serve(model, cloud, xyz)
    opt, sched = train.make_optimizer(cfg, model, 5)
    step(model, opt, sched, cloud, xyz, gt)
    ds = make_plot_dataset(np.random.default_rng(0), n_plots=6, n_points=300)
    dd = D.build_device_dataset(ds, sorted(ds), cfg.model, "cpu")
    idx = torch.from_numpy(D.epoch_index_table(6, 3, 0, 1))
    D.make_device_epoch(cfg, step)(model, opt, sched, dd, idx, torch.Generator().manual_seed(0))
    D.make_device_eval(cfg, train.make_eval_core(cfg, kde, "cpu"))(
        model, dd, idx, torch.Generator().manual_seed(0))
    assert ck.graph_counts() == {"captures": 0, "replays": 0}


# ---------------------------------------------------------------------------
# the steps through their programs (StandInGraphs)
# ---------------------------------------------------------------------------


def test_predict_program_over_three_batches_equals_three_steps(on_graphs):
    """`make_predict_program` over 3 different batches equals 3 eager
    steps, each batch's outputs its own."""
    cfg = tiny_cfg()
    model = random_model(cfg.model, 0, CPU)
    batches = [serve_batch(3, 256, torch.Generator().manual_seed(10 + i), CPU)
               for i in range(3)]
    step = predict.make_predict_step(cfg, device="cpu")
    graphs = stand_in(step.program)
    rasters, preds = predict.make_predict_program(cfg, "cpu", step=step)(
        model, [c for c, _ in batches], [x for _, x in batches])
    assert graphs.calls == ["run", "capture", "replay", "replay"]
    for i, (cloud, xyz) in enumerate(batches):
        r, p = step.body(model, cloud, xyz)
        assert torch.equal(torch.isnan(rasters[i]), torch.isnan(r))
        assert_bitwise(torch.nan_to_num(rasters[i]), torch.nan_to_num(r), f"rasters {i}")
        assert_bitwise(preds[i], p, f"pred_pl {i}")
    assert not torch.equal(preds[0], preds[2])


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_train_step_program_equals_the_eager_body(on_graphs, drop):
    """Three train steps through the program (the first eager, then a
    capture and two replays) equal three eager steps bit for bit: params,
    BN buffers, Adam's moments and count, loss parts and the schedule's lr
    across a staircase drop; with dropout, the generators end alike."""
    cfg = tiny_cfg(step_size=1)
    cfg = replace(cfg, model=replace(cfg.model, drop=drop))
    cloud, xyz, gt = train_batch(3, 256, torch.Generator().manual_seed(3), CPU)
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).numpy())
    base = random_model(cfg.model, 0, CPU, running_stats=False)
    sides = {}
    for side in ("program", "eager"):
        model = copy.deepcopy(base)
        opt, sched = train.make_optimizer(cfg, model, 2)  # lr drops after 2 updates
        step = train.make_train_step(cfg, kde, device="cpu")
        gen = torch.Generator().manual_seed(4) if drop else None
        if side == "program":
            stand_in(step.program)
            run = step
        else:
            run = _eager_step(step)
        comps = [run(model, opt, sched, cloud, xyz, gt, gen) for _ in range(3)]
        sides[side] = (model, opt, comps, gen)
    (pm, po, pc, pg), (em, eo, ec, eg) = sides["program"], sides["eager"]
    for i in range(3):
        for k in ec[i]:
            assert_bitwise(pc[i][k], ec[i][k], f"step {i} {k}")
    for (k, a), b in zip(pm.state_dict().items(), em.state_dict().values()):
        assert_bitwise(a, b, k)
    for pa, pb in zip(pm.parameters(), em.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert_bitwise(po.state[pa][key], eo.state[pb][key], key)
    assert po.param_groups[0]["lr"] == eo.param_groups[0]["lr"] < cfg.train.lr
    if drop:
        assert torch.equal(pg.get_state(), eg.get_state())


def test_device_epoch_and_eval_programs_equal_their_eager_runs(on_graphs):
    """Two device-resident epochs and an eval through their programs equal
    the same on the eager path bit for bit (the port's draws: each batch's
    augmentation and subsample)."""
    cfg = tiny_cfg(step_size=1)
    ds = make_plot_dataset(np.random.default_rng(5), n_plots=8, n_points=300)
    ids = sorted(ds)
    kde = fit_kde_mixture_from_dataset(ds)
    base = random_model(cfg.model, 0, CPU, running_stats=False)
    dd = D.build_device_dataset(ds, ids[:6], cfg.model, "cpu")
    dd_val = D.build_device_dataset(ds, ids[6:], cfg.model, "cpu")
    val_idx, _ = D.eval_index_table(2, 3)
    results = {}
    for side in ("program", "eager"):
        model = copy.deepcopy(base)
        opt, sched = train.make_optimizer(cfg, model, 2)
        step = train.make_train_step(cfg, kde, device="cpu")
        if side == "eager":  # the train step's body and the schedule, no program
            step = _eager_step(step)
        epoch = D.make_device_epoch(cfg, step)
        evaluate = D.make_device_eval(cfg, train.make_eval_core(cfg, kde, "cpu"))
        if side == "program":
            epoch_graphs, eval_graphs = stand_in(epoch.program), stand_in(evaluate.program)
        else:
            epoch, evaluate = _eager(epoch), _eager(evaluate)
        sums = []
        for e in (1, 2):
            idx = torch.from_numpy(D.epoch_index_table(6, 3, 0, e))
            sums.append(epoch(model, opt, sched, dd, idx, torch.Generator().manual_seed(e)))
        ev = evaluate(model, dd_val, torch.from_numpy(val_idx), torch.Generator().manual_seed(1))
        results[side] = (model, sums, ev)
    assert epoch_graphs.calls == ["run", "capture", "replay", "replay", "replay"]
    assert eval_graphs.calls == ["run", "capture"]
    (pm, ps, pe), (em, es, ee) = results["program"], results["eager"]
    for e in range(2):
        for k in es[e]:
            assert_bitwise(ps[e][k], es[e][k], f"epoch {e} {k}")
    for (k, a), b in zip(pm.state_dict().items(), em.state_dict().values()):
        assert_bitwise(a, b, k)
    assert_bitwise(pe[0], ee[0], "eval pred_pl")
    for k in ee[1]:
        assert_bitwise(pe[1][k], ee[1][k], f"eval {k}")


def _eager(run):
    """`run` (a device epoch or eval) on its eager path: the port's own
    draws passed explicitly, which no program takes."""
    def eager(*args):
        return run(*args, D.generator_draws(args[-1]))
    return eager


def _eager_step(step):
    def eager(model, optimizer, scheduler, *args):
        comps = step.body(model, optimizer, *args)
        scheduler.step()
        return comps

    eager.body = step.body
    return eager


def test_programs_share_one_side_stream_a_card(monkeypatch):
    """Every program's warm-up and capture run on one side stream a card:
    cuBLAS keeps a workspace for each stream it has run on until the
    process ends, so a stream a program would grow the card's memory fold
    after fold."""
    made = []
    monkeypatch.setattr(programs.CudaGraphs, "_streams", {})
    monkeypatch.setattr(torch.cuda, "Stream", lambda index: made.append(index) or object())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    a, b = (programs.StepProgram(lambda: None).graphs for _ in range(2))
    assert a is not b
    cuda0 = torch.device("cuda", 0)
    assert a._side(cuda0) is b._side(torch.device("cuda")) is a._side(cuda0)
    assert b._side(torch.device("cuda", 1)) is not a._side(cuda0)
    assert made == [0, 1]
