"""kimi-k2-1t-a32b on the port against the JAX package.

kimi's smoke config (top-2 of 4 experts, head dim 16) cut to two layers
(G = 2, so its expert leaves hold 2**16 elements and take the factored
second moment) in f32, on weights made by the JAX ``init_params`` and
carried over by ``repro_torch.bridge``.  The capacity factor is raised to
4.0, where no bucket can fill and the JAX bucket fault cannot fire
(tests/test_torch_moe.py pins that fault); at the config's own 1.25 the
port's paged tokens must equal its slotted ones.

Tolerances, all f32: prefill logits and decode logits and caches 1e-4 of
each one's scale (tests/test_torch_moe.py's); the loss 1e-5 and each grad
leaf 1e-4 of its norm (tests/test_torch_train_families.py's); one
``train_step`` under kimi's own recipe (int8 ``m``, factored ``v`` on the
expert leaves, int8 ``v`` on the rest) against one ``build_train`` step:
params 1e-5 absolute, a thirtieth of lr = 3e-4 (they lie 1.8e-6 apart at
most: a step reads the f32 moments before they are stored), the factored
means 1e-3 relative + 1e-6, the int8 scales 1e-3 relative + 2e-5 / 127 (a
block's scale is its largest |m| / 127), and ``q`` equal but for +-1 flips (grads 1e-4 apart move values
across a rounding boundary), counted and under 1 in 100.  A TrainJob with
the recipe through both Sessions, at Adam eps 1e-5: the losses within
1e-5 (under eps 1e-8 an element whose int8 ``v`` rounds to 0 steps by
m / eps, and one +-1 flip of such a ``q`` between the stacks moves the
fourth loss by 1e-3).  The checkpoint: bit for bit.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi                                   # noqa: E402
from repro.api import runners as jrunners                       # noqa: E402
from repro.checkpoint.checkpoint import Checkpointer as JCkpt   # noqa: E402
from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.configs.base import ShapeConfig                      # noqa: E402
from repro.core.orchestrator import Cluster as JCluster         # noqa: E402
from repro.core.queue import WorkQueue as JQueue                # noqa: E402
from repro.data.objectstore import ObjectStore as JStore        # noqa: E402
from repro.launch.mesh import single_device_mesh                # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.models import transformer as jtfm                    # noqa: E402
from repro.models.layers import ModelCtx                        # noqa: E402
from repro.optim import adamw as jadamw                         # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402
from repro.serving.engine import ServingEngine as JEngine       # noqa: E402

from repro_torch import bridge                                  # noqa: E402
from repro_torch.api import Session, TrainJob                   # noqa: E402
from repro_torch.api import runners                             # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer      # noqa: E402
from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.core.orchestrator import Cluster               # noqa: E402
from repro_torch.core.queue import WorkQueue as TQueue          # noqa: E402
from repro_torch.data.objectstore import ObjectStore            # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models import transformer as ttfm              # noqa: E402
from repro_torch.optim import adamw as tadamw                   # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

ARCH = "kimi-k2-1t-a32b"
F32 = dict(param_dtype="float32", compute_dtype="float32", num_layers=2)
B, S = 2, 16
LOSS_RTOL, LEAF_RTOL = 1e-5, 1e-4
SCHEDULE = dict(warmup_steps=1, decay_steps=100)
STEP_EPS = 1e-5        # as tests/test_torch_train_families.py (see there)
RECIPE = dict(moment_dtype="int8", second_moment="factored")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads a team: the suite runs several workers on one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfgs(cf=4.0):
    out = []
    for reg in (jreg, treg):
        cfg = reg.get_smoke(ARCH).replace(**F32)
        out.append(cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    jcfg, _ = _cfgs()
    p = jax.jit(lambda k: jpr.init_params(jtfm.lm_schema(jcfg), k,
                                          "float32"))(jax.random.key(seed))
    return jax.tree.map(np.asarray, p)


def _port(tree):
    return bridge.to_torch(tree, device="cpu")


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _close(got, want, tol=1e-4):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _pairs(want, got, path=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), path
        for k in sorted(want):
            yield from _pairs(want[k], got[k], f"{path}/{k}")
        return
    yield path, np.asarray(want), got.detach()


# ------------------------------------------------------------------ config

def test_config_registry_and_schemas_match_jax():
    for get in ("get_config", "get_smoke", "get_parallel", "get_optimizer"):
        assert dataclasses.asdict(getattr(treg, get)(ARCH)) == \
            dataclasses.asdict(getattr(jreg, get)(ARCH))
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)
    cfg = treg.get_config(ARCH)
    assert cfg.resolved_head_dim == 112 and cfg.moe.num_experts == 384
    want = {k: (v.shape, v.axes, v.init, v.scale, v.dtype)
            for k, v in jpr._leaves(jtfm.lm_schema(jreg.get_config(ARCH)))}
    got = {k: (v.shape, v.axes, v.init, v.scale, v.dtype)
           for k, v in tpr.leaves(ttfm.lm_schema(cfg))}
    assert got == want
    # 61 layers of 384 experts: about 1.03 T params
    assert 1.0e12 < tpr.param_count(ttfm.lm_schema(cfg)) < 1.1e12


# ----------------------------------------------------------------- serving

def test_prefill_slotted_and_paged_decode_match_jax():
    """A prefill, then four decode steps slotted and four paged (block 4,
    the null block 0 in the tables), logits and caches against JAX."""
    jcfg, tcfg = _cfgs()
    ctx = ModelCtx(jcfg, jreg.get_parallel(ARCH), None)
    jp = _jax_params()
    tp = _port(jp)
    P, steps = 12, 4
    rng = np.random.RandomState(9)
    toks = rng.randint(1, jcfg.vocab_size, (1, P))
    jx, jcache, _ = jtfm.forward(ctx, jp, jnp.asarray(toks, jnp.int32),
                                 mode="prefill")
    tx, tcache = ttfm.forward(tcfg, tp, torch.as_tensor(toks),
                              mode="prefill")
    _close(ttfm.lm_logits(tcfg, tp, tx[:, -1:]),
           jtfm.lm_logits(ctx, jp, jx[:, -1:]))
    for path, want, got in _pairs(jax.tree.map(np.asarray, jcache), tcache):
        _close(got, want)

    L = P + steps
    jbig = jsteps.cache_batch_insert(jsteps.init_cache(jcfg, 1, L), jcache, 0)
    slotted = tsteps.cache_batch_insert(tsteps.init_cache(tcfg, 1, L, "cpu"),
                                        tcache, 0)
    pool = tsteps.init_paged_cache(tcfg, 1 + L // 4, 4, "cpu")
    tables = torch.arange(1, 1 + L // 4)[None]
    tsteps.paged_prompt_insert(pool, tcache, tables[0, :P // 4])
    tok = rng.randint(1, jcfg.vocab_size, (1, 1))
    jtok = ttok = ptok = tok
    for i in range(steps):
        jx, jbig, _ = jtfm.forward(ctx, jp, jnp.asarray(jtok, jnp.int32),
                                   mode="decode", caches=jbig,
                                   pos=jnp.int32(P + i))
        want = jtfm.lm_logits(ctx, jp, jx)
        tx, slotted = ttfm.forward(tcfg, tp, torch.as_tensor(ttok),
                                   mode="decode", caches=slotted, pos=P + i)
        _close(ttfm.lm_logits(tcfg, tp, tx), want)
        nxt, pool = tsteps.paged_decode_step(
            tcfg, tp, pool, tables, torch.as_tensor(ptok),
            torch.tensor([P + i]))
        jtok = np.asarray(want).argmax(-1)
        ttok = ptok = jtok
        assert int(nxt[0, 0]) == int(jtok[0, 0])
    for path, want, got in _pairs(jax.tree.map(np.asarray, jbig), slotted):
        _close(got, want)
    view = tsteps.paged_cache_view(pool, tables)
    for path, a, b in _pairs(bridge.to_numpy(slotted), view):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)


def _requests(cfg, gens, seed=10, shared_prefix=0):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, cfg.vocab_size, shared_prefix).tolist()
    return [{"id": i, "prompt": head + rng.randint(
        1, cfg.vocab_size, 8 - shared_prefix).tolist(), "max_new_tokens": g}
        for i, g in enumerate(gens)]


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_equal_jax_engine(paged):
    jcfg, tcfg = _cfgs()
    jp = _jax_params(1)
    kw = dict(num_slots=2, prompt_len=8, max_new_tokens=8, paged=paged)
    if paged:
        kw.update(block_size=4, prefix_cache=True)
    j = JEngine(jcfg, jreg.get_parallel(ARCH), single_device_mesh(),
                params=jp, **kw)
    t = TEngine(tcfg, device="cpu", params=_port(jp), **kw)
    gens = [6, 2, 4, 5, 3]
    reqs = _requests(jcfg, gens, shared_prefix=4 if paged else 0)
    r_j, _ = j.run(JQueue(reqs))
    r_t, _ = t.run(TQueue(reqs))
    assert r_t == r_j
    assert [len(r_t[i]) for i in range(len(gens))] == gens


def test_paged_equals_slotted_at_the_configs_capacity_factor():
    _, tcfg = _cfgs(1.25)
    params = _port(_jax_params(2))
    reqs = _requests(tcfg, [6, 2, 7, 4, 5], seed=5)
    out = {}
    for paged in (False, True):
        eng = TEngine(tcfg, device="cpu", params=params, num_slots=3,
                      prompt_len=8, max_new_tokens=8, paged=paged,
                      block_size=4, prefix_cache=False)
        out[paged] = eng.run(TQueue(reqs))[0]
    assert out[True] == out[False]


# ---------------------------------------------------------------- training

def _batch(cfg, seed=3):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's ``value_and_grad`` of ``loss_fn`` and one ``build_train``
    step under kimi's own recipe, from the same weights and batch."""
    jcfg, _ = _cfgs()
    params, batch = _jax_params(), _batch(jcfg)
    par = jreg.get_parallel(ARCH)
    ctx = ModelCtx(jcfg, par, None)
    mesh = single_device_mesh()
    ocfg = JOpt(eps=STEP_EPS, **SCHEDULE, **RECIPE)
    step = jsteps.build_train(jcfg, par, ocfg, mesh,
                              ShapeConfig("t", S, B, "train")).fn
    schema = jtfm.lm_schema(jcfg)

    def both(p, o, b):
        return jax.value_and_grad(lambda q: jtfm.loss_fn(ctx, q, b))(p), \
            step(p, o, b)
    with mesh:
        opt = jax.jit(lambda: jpr.init_params(
            jadamw.opt_state_schema(schema, ocfg), jax.random.key(1),
            "float32"))()
        (jl, jg), out = jax.jit(both)(jax.tree.map(jnp.asarray, params), opt,
                                      jax.tree.map(jnp.asarray, batch))
    return float(jl), *jax.tree.map(np.asarray, (jg, out))


def _rel(got, want):
    return np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want)


def test_loss_and_grads_match_jax():
    _, tcfg = _cfgs()
    jl, jg, _ = _jax_reference()
    tl, tg = tsteps._value_and_grad(
        tcfg, tsteps.train_par(treg.get_parallel(ARCH)),
        _port(_jax_params()), jax.tree.map(torch.as_tensor, _batch(tcfg)))
    np.testing.assert_allclose(float(tl), jl, rtol=LOSS_RTOL)
    for path, want, got in _pairs(jg, tg):
        assert _rel(got, want) <= LEAF_RTOL, path


def test_one_train_step_under_kimis_recipe_matches_build_train():
    _, tcfg = _cfgs()
    _, _, (jp, jo, jm) = _jax_reference()
    ocfg = OptimizerConfig(eps=STEP_EPS, **SCHEDULE, **RECIPE)
    assert treg.get_optimizer(ARCH) == OptimizerConfig(**RECIPE)
    tp, to, tm = tsteps.train_step(
        tcfg, treg.get_parallel(ARCH), ocfg, _port(_jax_params()),
        tsteps.init_opt_state(tcfg, ocfg, "cpu"), _batch(tcfg),
        device="cpu")
    np.testing.assert_allclose(float(tm["loss"]), jm["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), jm["grad_norm"],
                               rtol=LEAF_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), jm["lr"], rtol=1e-6)
    assert int(to["count"]) == int(jo["count"]) == 1
    for path, want, got in _pairs(jp, tp):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=path)
    flips = total = 0
    kinds = set()
    for path, want, got in _pairs({"m": jo["m"], "v": jo["v"]},
                                  {"m": to["m"], "v": to["v"]}):
        kinds.add(path.rsplit("/", 1)[-1])
        assert got.dtype == getattr(torch, str(want.dtype)), path
        got = got.numpy()
        if path.endswith("/q"):
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, path
            flips += int((diff > 0).sum())
            total += diff.size
        elif path.endswith("/s"):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-5 / 127,
                                       err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6,
                                       err_msg=path)
    assert kinds == {"q", "s", "vr", "vc"}
    assert flips <= 1e-2 * total, (flips, total)


def test_train_job_with_the_recipe_matches_the_jax_session(monkeypatch):
    """A kimi-smoke TrainJob whose ``optimizer:`` asks for the memory
    recipe, through the JAX Session and the port's, from the same JAX
    weights (the port's ``init_params`` returns JAX's draw for the seed)."""
    jcfg, tcfg = _cfgs()

    def init(schema, gen, dtype, device="cuda"):
        p = jpr.init_params(jtfm.lm_schema(jcfg),
                            jax.random.key(gen.initial_seed()), dtype)
        return bridge.to_torch(jax.tree.map(np.asarray, p), device=device)
    monkeypatch.setattr(tpr, "init_params", init)
    kw = dict(steps=4, seq_len=16, global_batch=2, log_every=1,
              verbose=False, optimizer=dict(lr=1e-3, eps=STEP_EPS, **RECIPE))
    want = japi.Session(cluster=JCluster(devices=jax.devices())).apply(
        japi.TrainJob(name="kimi", config=jrunners.dataclass_kwargs(jcfg),
                      **kw)).wait(300)
    job = TrainJob(name="kimi", config=runners.dataclass_kwargs(tcfg), **kw)
    assert runners.train_pieces(job)[2].moment_dtype == "int8"
    got = Session(cluster=Cluster(devices=[torch.device("cpu")])).apply(
        job).wait(300)
    assert len(got["losses"]) == len(want["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)


def test_a_jax_checkpoint_of_the_quantized_state_restores_bit_for_bit(
        tmp_path):
    """JAX saves params and a kimi-recipe state after one step; the port
    restores it onto the CPU bit for bit (int8 stored as int8), the
    bridge carries the same tree to the same bits, and the port's own
    save of it writes the same keys, shapes and dtypes."""
    _, tcfg = _cfgs()
    _, _, (jp, jo, _) = _jax_reference()
    tree = {"params": jp, "opt": jo}
    JCkpt(JStore(str(tmp_path / "jax")), keep=None).save(1, tree)
    schema = ttfm.lm_schema(tcfg)
    abstract = {"params": tpr.abstract_params(schema, "float32"),
                "opt": tpr.abstract_params(tadamw.opt_state_schema(
                    schema, OptimizerConfig(**RECIPE)), "float32")}
    got = Checkpointer(ObjectStore(str(tmp_path / "jax")), keep=None).restore(
        1, abstract, "cpu")
    carried = bridge.to_torch(jax.tree.map(np.asarray, tree), device="cpu")
    for path, a, b in _pairs(bridge.to_numpy(carried), got):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=path)
    n = 0
    for path, want, leaf in _pairs(jax.tree.map(np.asarray, tree), got):
        assert leaf.dtype == getattr(torch, str(want.dtype)), path
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=path)
        n += path.endswith("/q")
    assert n > 0
    Checkpointer(ObjectStore(str(tmp_path / "port")), keep=None).save(1, got)

    def manifest(root):
        with open(tmp_path / root / "checkpoints" / f"step_{1:010d}" /
                  "MANIFEST.json") as f:
            return {e["key"]: (e["shape"], e["dtype"])
                    for e in json.load(f)["leaves"]}
    assert manifest("port") == manifest("jax")
    assert manifest("jax")["opt/m/blocks/0_moe/moe_wg/q"][1] == "int8"
    assert manifest("jax")["opt/v/blocks/0_moe/moe_wg/vr"][1] == "float32"


def test_elastic_crash_and_resume_under_the_recipe_is_bit_for_bit(tmp_path):
    """The quantized and factored state through ``ElasticTrainer``: a run
    that crashes before step 5 and restores the step-3 checkpoint (int8
    ``q`` and f32 ``s``, ``vr``, ``vc`` read back as saved) repeats a
    clean run's losses bit for bit."""
    from repro_torch.elastic import ElasticTrainer, ElasticTrainSpec
    _, tcfg = _cfgs()
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, decay_steps=8, **RECIPE)

    def run(name, fail_at):
        spec = ElasticTrainSpec(tcfg, treg.get_parallel(ARCH), ocfg, steps=6,
                                seq_len=16, global_batch=2, ckpt_every=2,
                                fail_at=fail_at, verbose=False, device="cpu")
        return ElasticTrainer(Cluster(devices=["slot0"]), spec,
                              store=ObjectStore(str(tmp_path / name))).run()
    clean, crashed = run("clean", -1), run("crash", 5)
    assert [s.outcome for s in crashed["report"].segments] == ["error",
                                                               "done"]
    assert crashed["losses"] == clean["losses"] and len(clean["losses"]) == 6


def test_rl_chunk_trains_under_the_recipe():
    """The RL learner's chunk (``rl_train_chunk``) on the quantized and
    factored state: finite losses, and every state leaf keeps its
    schema's dtype and shape."""
    _, tcfg = _cfgs()
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, **RECIPE)
    rng = np.random.RandomState(4)
    K = 2
    batches = {"tokens": rng.randint(1, tcfg.vocab_size, (K, B, S)),
               "labels": rng.randint(1, tcfg.vocab_size, (K, B, S)),
               "mask": (rng.rand(K, B, S) > 0.5).astype(np.float32),
               "advantages": rng.standard_normal((K, B)).astype(np.float32)}
    opt = tsteps.init_opt_state(tcfg, ocfg, "cpu")
    _, opt, ms = tsteps.rl_train_chunk(
        tcfg, treg.get_parallel(ARCH), ocfg, _port(_jax_params()), opt,
        batches, device="cpu")
    assert np.isfinite(ms["loss"].numpy()).all() and int(opt["count"]) == K
    want = tpr.abstract_params(
        tadamw.opt_state_schema(ttfm.lm_schema(tcfg), ocfg), "float32")
    assert [(t.dtype, t.shape) for t in tsteps.tree_leaves(opt)] == \
        [(t.dtype, t.shape) for t in tsteps.tree_leaves(want)]
