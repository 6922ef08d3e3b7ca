"""The port's CONNECT case study (``repro_torch.apps.connect``,
``models.ffn3d``, ``data.volumes``) against the JAX package's.

Same numpy inputs through both stacks, f32 on the CPU, at the sizes of
``tests/test_connect.py`` (vol 32 x 48 x 8 frames, 2 events; FFN depth 2,
width 8, fov 8 x 16 x 16, 2 flood iterations; 15 steps):

- ``generate_chunk`` / ``subvolumes``: byte-equal arrays;
- ``ffn_schema``: the same leaves, shapes and inits; on the same params
  (carried over by ``repro_torch.bridge``) ``ffn_apply``, ``flood_fill``
  and ``bce_loss`` within 1e-5 of the output's scale (the convolutions
  sum the same products in another order), ``bce_loss``'s grads within
  1e-4 per leaf norm, ``seed_mask`` and ``iou`` equal;
- ``connect_label``: exactly equal (integer arithmetic), ``object_stats``
  equal;
- the whole workflow, with the JAX init through the ``init_params`` seam:
  train losses within 1e-4 relative (15 SGD steps compound the f32
  differences above), masks equal except voxels whose JAX logit lies
  within 1e-4 of 0 (counted), ``analyze`` equal, and a second run skips
  every step; a JAX run stopped after ``train`` is finished by the port
  from JAX's model files, and the port's model files load in JAX;
- the graph twin manifest and the reference tiling (remainders stay 0).

Workers run in threads, so torch is pinned to two threads a team here.
"""
import json
import pathlib
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi                                    # noqa: E402
from repro.apps.connect import pipeline as jpipe                 # noqa: E402
from repro.apps.connect import segment as jseg                   # noqa: E402
from repro.core.metrics import Registry as JRegistry             # noqa: E402
from repro.core.orchestrator import Cluster as JCluster          # noqa: E402
from repro.data import volumes as jvol                           # noqa: E402
from repro.data.objectstore import ObjectStore as JObjectStore   # noqa: E402
from repro.models import ffn3d as jffn                           # noqa: E402
from repro.models import params as jpr                           # noqa: E402

from repro_torch import bridge                                   # noqa: E402
from repro_torch.api import Session, WorkloadState              # noqa: E402
from repro_torch.apps.connect import pipeline as tpipe           # noqa: E402
from repro_torch.apps.connect import segment as tseg             # noqa: E402
from repro_torch.core.metrics import Registry                    # noqa: E402
from repro_torch.core.orchestrator import Cluster                # noqa: E402
from repro_torch.data import volumes as tvol                     # noqa: E402
from repro_torch.data.objectstore import ObjectStore             # noqa: E402
from repro_torch.models import ffn3d as tffn                     # noqa: E402
from repro_torch.models import params as tpr                     # noqa: E402

KW = dict(n_chunks=2, download_workers=2, inference_workers=2,
          vol=dict(lat=32, lon=48, frames=8, events=2),
          ffn=dict(depth=2, width=8, fov=(8, 16, 16), flood_iters=2),
          train_steps=15)
JCC, TCC = jpipe.connect_config(**json.loads(json.dumps(KW))), \
    tpipe.connect_config(**json.loads(json.dumps(KW)))
STEPS = ["download", "train", "inference", "analyze"]
NEAR_ZERO = 1e-4
GRAPH = pathlib.Path(tpipe.__file__).with_name("connect_graph.json")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Download and inference workers run in threads, each of which starts
    an OpenMP team of every core; two threads a team."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def cpu_cluster():
    cluster = Cluster(devices=[torch.device("cpu")])
    cluster.create_namespace("atmos-science")
    return cluster


def jax_cluster():
    cluster = JCluster(devices=jax.devices())
    cluster.create_namespace("atmos-science")
    return cluster


def jax_init(ffn_cfg):
    """The port's ``init_params`` returning the JAX draw for the
    generator's seed (``jax.random`` cannot be reproduced in torch)."""
    def init(schema, gen, dtype, device="cuda"):
        p = jpr.init_params(jffn.ffn_schema(ffn_cfg),
                            jax.random.key(gen.initial_seed()), dtype)
        return bridge.to_torch(jax.tree.map(np.asarray, p), device=device)
    return init


def random_params(cfg, seed=0, scale=0.2):
    """Every leaf drawn (the blocks' second convs too, which init at 0)."""
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(p.shape) * scale).astype(np.float32)
            for k, p in jffn.ffn_schema(cfg).items()}


def jax_logits(root, cc, key):
    """The JAX flood-fill logit of every voxel of one chunk, tiled as
    ``_chunk_mask`` tiles it; inf where no tile covers the voxel."""
    store = JObjectStore(str(root))
    params = jpipe._load_ffn_params(store, cc)
    ivt = store.get_array(f"{key}/ivt.npy")
    ft, fy, fx = cc.ffn.fov
    out = np.full(ivt.shape, np.inf, np.float32)
    T, LA, LO = ivt.shape
    for t in range(0, T - ft + 1, ft):
        for y in range(0, LA - fy + 1, fy):
            for x in range(0, LO - fx + 1, fx):
                tile = jnp.asarray(ivt[None, t:t + ft, y:y + fy, x:x + fx])
                out[t:t + ft, y:y + fy, x:x + fx] = np.asarray(
                    jffn.flood_fill(cc.ffn, params, tile))[0]
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax-connect")
    wf = jpipe.build_workflow(jax_cluster(), JObjectStore(str(root)), JCC)
    return root, wf.run()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port-connect")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpr, "init_params", jax_init(JCC.ffn))
        wf = tpipe.build_workflow(cpu_cluster(), ObjectStore(str(root)), TCC)
        results = wf.run()
    return root, results, wf


# ------------------------------------------------------------------ volumes
@pytest.mark.parametrize("spec,cid", [
    (dict(lat=32, lon=48, frames=8, events=2), 0),
    (dict(lat=32, lon=48, frames=8, events=2), 7),
    (dict(lat=40, lon=56, frames=12, events=3, threshold=0.5), 2 ** 31 + 3),
])
def test_volumes_are_byte_equal(spec, cid):
    jivt, jlab = jvol.generate_chunk(jvol.VolumeSpec(**spec), cid)
    tivt, tlab = tvol.generate_chunk(tvol.VolumeSpec(**spec), cid)
    assert tivt.tobytes() == jivt.tobytes() and tivt.dtype == jivt.dtype
    assert tlab.tobytes() == jlab.tobytes() and tlab.dtype == jlab.dtype
    for fov, stride in (((8, 16, 16), (4, 8, 8)), ((16, 16, 16), (1, 9, 5))):
        got = tvol.subvolumes(tivt, tlab, fov, stride)
        want = jvol.subvolumes(jivt, jlab, fov, stride)
        assert len(got) == len(want) > 0
        for (a, b), (c, d) in zip(got, want):
            assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
    assert tvol.chunk_keys(3, "p") == jvol.chunk_keys(3, "p")


# --------------------------------------------------------------------- FFN
@pytest.mark.parametrize("cfg", [dict(depth=2, width=8, fov=(8, 16, 16)),
                                 dict()])
def test_ffn_schema_matches(cfg):
    got, want = tffn.ffn_schema(tffn.FFNConfig(**cfg)), \
        jffn.ffn_schema(jffn.FFNConfig(**cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].shape, got[k].init, got[k].scale) == \
            (want[k].shape, want[k].init, want[k].scale)
    assert [p for p, _ in tpr.leaves(got)] == sorted(want)


def _scale_close(got, want, tol):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= tol * max(np.max(np.abs(want)), 1.0), err


def _ffn_inputs(cfg, seed=3, B=2):
    rng = np.random.RandomState(seed)
    shape = (B,) + tuple(cfg.fov)
    ivt = rng.rand(*shape).astype(np.float32)
    mask = (rng.standard_normal(shape) * 2).astype(np.float32)
    labels = (rng.rand(*shape) > 0.7).astype(np.uint8)
    return ivt, mask, labels


def test_ffn_forward_and_flood_fill_match_jax():
    jcfg = jffn.FFNConfig(depth=2, width=8, fov=(8, 16, 16), flood_iters=2)
    tcfg = tffn.FFNConfig(depth=2, width=8, fov=(8, 16, 16), flood_iters=2)
    params = random_params(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = bridge.to_torch(params, device="cpu")
    ivt, mask, labels = _ffn_inputs(jcfg)
    _scale_close(tffn.ffn_apply(tcfg, tp, torch.as_tensor(ivt),
                                torch.as_tensor(mask)),
                 jffn.ffn_apply(jcfg, jp, jnp.asarray(ivt), jnp.asarray(mask)),
                 1e-5)
    _scale_close(tffn.flood_fill(tcfg, tp, torch.as_tensor(ivt)),
                 jffn.flood_fill(jcfg, jp, jnp.asarray(ivt)), 1e-5)
    _scale_close(tffn.bce_loss(tcfg, tp, torch.as_tensor(ivt),
                               torch.as_tensor(labels)),
                 jffn.bce_loss(jcfg, jp, jnp.asarray(ivt),
                               jnp.asarray(labels)), 1e-5)
    for shape in ((1, 8, 16, 16), (2, 3, 5, 4)):
        np.testing.assert_array_equal(
            tffn.seed_mask(tcfg, shape, "cpu").numpy(),
            np.asarray(jffn.seed_mask(jcfg, shape)))


def test_bce_grads_match_jax_per_leaf():
    jcfg = jffn.FFNConfig(depth=2, width=8, fov=(8, 16, 16))
    tcfg = tffn.FFNConfig(depth=2, width=8, fov=(8, 16, 16))
    params = random_params(jcfg, seed=1, scale=0.1)
    ivt, _, labels = _ffn_inputs(jcfg, seed=4, B=3)
    want = jax.grad(lambda p: jffn.bce_loss(jcfg, p, jnp.asarray(ivt),
                                            jnp.asarray(labels)))(
        jax.tree.map(jnp.asarray, params))
    tp = {k: v.requires_grad_(True)
          for k, v in bridge.to_torch(params, device="cpu").items()}
    loss = tffn.bce_loss(tcfg, tp, torch.as_tensor(ivt),
                         torch.as_tensor(labels))
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)])
    for k, g in zip(sorted(tp), grads):
        w = np.asarray(want[k])
        assert g.shape == w.shape
        np.testing.assert_allclose(np.linalg.norm(g.numpy()),
                                   np.linalg.norm(w), rtol=1e-4, atol=1e-12)
        _scale_close(g.numpy(), w, 1e-4)


def test_iou_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(3):
        p, l = rng.rand(4, 6, 7) > 0.5, rng.rand(4, 6, 7) > 0.4
        assert float(tffn.iou(torch.as_tensor(p), torch.as_tensor(l))) == \
            float(jffn.iou(jnp.asarray(p), jnp.asarray(l)))
    empty = np.zeros((2, 2, 2), bool)
    assert float(tffn.iou(torch.as_tensor(empty), torch.as_tensor(empty))) \
        == float(jffn.iou(jnp.asarray(empty), jnp.asarray(empty))) == 0.0


def test_reference_convs_restore_the_flags_after_the_last_thread():
    """The cuDNN flags are process-wide: the first user sets them, the
    last restores the caller's values, whatever the interleaving."""
    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.deterministic)
    inside, go = [], threading.Barrier(4, timeout=10)

    def user():
        with tffn.reference_convs():
            go.wait()
            inside.append((cudnn.allow_tf32, cudnn.deterministic))
            go.wait()

    threads = [threading.Thread(target=user) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert inside == [(False, True)] * 4
    assert (cudnn.allow_tf32, cudnn.deterministic) == before


def test_inference_enters_inference_mode_in_its_own_thread():
    cfg = tffn.FFNConfig(depth=1, width=4, fov=(4, 8, 8), flood_iters=1)
    params = {k: v.requires_grad_(True) for k, v in bridge.to_torch(
        random_params(jffn.FFNConfig(depth=1, width=4)), "cpu").items()}
    infer = tpipe._ffn_infer(tpipe.ConnectConfig(ffn=cfg), params)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "m", infer(np.random.RandomState(0).rand(2, 4, 8, 8)
                   .astype(np.float32))))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out["m"].dtype == torch.bool and out["m"].shape == (2, 4, 8, 8)
    assert not out["m"].requires_grad and out["m"].is_inference()


# ------------------------------------------------------------ CONNECT label
@pytest.mark.parametrize("seed,shape,p", [
    (0, (4, 6, 6), 0.6), (1, (4, 6, 6), 0.6), (2, (5, 12, 16), 0.5),
    (3, (5, 12, 16), 0.45), (4, (8, 20, 9), 0.4), (5, (1, 7, 1), 0.5)])
def test_connect_label_is_exactly_jax(seed, shape, p):
    mask = np.random.RandomState(seed).rand(*shape) > p
    got = tseg.connect_label(torch.as_tensor(mask)).numpy()
    want = np.asarray(jseg.connect_label(jnp.asarray(mask)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tseg.object_stats(got) == jseg.object_stats(want)


def test_connect_tracks_lifecycle_through_time():
    mask = np.zeros((5, 8, 8), np.uint8)
    for t in range(5):
        mask[t, 2:5, t:t + 3] = 1
    labels = tseg.connect_label(torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(
        labels, np.asarray(jseg.connect_label(jnp.asarray(mask))))
    stats = tseg.object_stats(labels)
    assert stats == jseg.object_stats(labels)
    assert len(stats) == 1
    assert (stats[0]["genesis_frame"], stats[0]["termination_frame"],
            stats[0]["duration"]) == (0, 4, 5)
    assert stats[0]["drift"] > 0


def test_two_separate_events_are_two_objects():
    mask = np.zeros((4, 10, 10), np.uint8)
    mask[0:2, 1:3, 1:3] = 1
    mask[2:4, 7:9, 7:9] = 1
    labels = tseg.connect_label(torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(
        labels, np.asarray(jseg.connect_label(jnp.asarray(mask))))
    assert len(tseg.object_stats(labels)) == 2


# ----------------------------------------------------------- the workflow
def test_workflow_matches_jax(jax_run, port_run):
    jroot, want = jax_run
    troot, got, _ = port_run
    assert got["download"] == want["download"]
    assert got["train"]["n_windows"] == want["train"]["n_windows"]
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got["train"][k], want["train"][k],
                                   rtol=1e-4)
    assert got["train"]["last_loss"] < got["train"]["first_loss"]
    assert got["inference"]["chunks"] == want["inference"]["chunks"]
    # every chunk's voxels counted; the reference's workers add to the
    # total without a lock and can lose a chunk's count (ROADMAP queue C)
    n = TCC.n_chunks * TCC.vol.frames * TCC.vol.lat * TCC.vol.lon
    assert got["inference"]["voxels"] == n
    assert want["inference"]["voxels"] in range(n // TCC.n_chunks, n + 1)
    js, ts = JObjectStore(str(jroot)), ObjectStore(str(troot))
    for key in tvol.chunk_keys(TCC.n_chunks):
        for f in ("ivt.npy", "labels.npy"):
            assert ts.get(f"{key}/{f}") == js.get(f"{key}/{f}")
        tm, jm = ts.get_array(f"{key}/mask.npy"), js.get_array(
            f"{key}/mask.npy")
        assert tm.dtype == jm.dtype == np.uint8 and tm.shape == jm.shape
        near = np.abs(jax_logits(jroot, JCC, key)) < NEAR_ZERO
        differ = tm != jm
        assert not (differ & ~near).any(), int((differ & ~near).sum())
        assert near.sum() < 1e-3 * near.size, int(near.sum())
    assert got["analyze"] == want["analyze"]
    assert got["analyze"]["objects"] >= 1


def test_second_run_skips_every_step(port_run):
    troot, results, wf = port_run
    assert [r.step for r in wf.reports] == STEPS
    wf2 = tpipe.build_workflow(cpu_cluster(), ObjectStore(str(troot)), TCC)
    again = wf2.run()
    assert again["analyze"] == results["analyze"]
    assert wf2.reports == []
    for s in STEPS:
        assert wf2.metrics.series(f"workflow/connect/{s}/skipped").total == 1
    assert "Total Time" in wf.table_one()


def test_model_files_load_across_the_stacks(port_run):
    troot, _, _ = port_run
    want = jpipe._load_ffn_params(JObjectStore(str(troot)), JCC)
    got = tpipe._load_ffn_params(ObjectStore(str(troot)), TCC, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    names = sorted(ObjectStore(str(troot)).list("models/ffn"))
    assert names == [f"models/ffn/{k}.npy" for k in sorted(want)]


def test_port_finishes_a_jax_run_stopped_after_train(tmp_path, jax_run):
    jroot, want = jax_run
    jwf = jpipe.build_workflow(jax_cluster(), JObjectStore(str(tmp_path)),
                               JCC)
    jwf.run(only="download")
    jwf.run(only="train")
    twf = tpipe.build_workflow(cpu_cluster(), ObjectStore(str(tmp_path)),
                               TCC)
    got = twf.run()
    assert [r.step for r in twf.reports] == ["inference", "analyze"]
    assert got["train"] == json.loads(json.dumps(want["train"]))
    for key in tvol.chunk_keys(TCC.n_chunks):
        # the JAX full run trained the same model (JAX on the CPU is
        # deterministic): its masks are what JAX's inference gives here
        near = np.abs(jax_logits(tmp_path, JCC, key)) < NEAR_ZERO
        mask = ObjectStore(str(tmp_path)).get_array(f"{key}/mask.npy")
        jmask = JObjectStore(str(jroot)).get_array(f"{key}/mask.npy")
        assert not ((mask != jmask) & ~near).any()
    assert got["analyze"] == want["analyze"]


def test_a_step_without_a_device_raises(tmp_path):
    """A cluster of bare logical slots has nowhere to compute: the train
    step raises instead of running on the CPU by itself."""
    cluster = Cluster(devices=[0, 1])
    cluster.create_namespace("atmos-science")
    wf = tpipe.build_workflow(cluster, ObjectStore(str(tmp_path)), TCC)
    wf.run(only="download")
    with pytest.raises(RuntimeError, match="no online CUDA or CPU"):
        wf.run(only="train")


# ------------------------------------------------------------- the twins
def test_graph_twin_is_the_jax_manifest_with_port_entrypoints():
    want = json.loads(pathlib.Path(
        "examples/manifests/connect_graph.json").read_text())
    got = json.loads(GRAPH.read_text())
    nodes = got["spec"]["graph"]["nodes"]
    for n in nodes:
        assert n["entrypoint"].startswith("repro_torch.apps.connect.")
        n["entrypoint"] = n["entrypoint"].replace("repro_torch.", "repro.", 1)
    assert got == want
    plan = json.loads(json.dumps(want["spec"]["graph"]["nodes"][0]["params"]))
    built = tpipe.connect_graph(**plan)
    assert [n["entrypoint"] for n in built["nodes"]] == \
        [n["entrypoint"].replace("repro.", "repro_torch.", 1)
         for n in json.loads(GRAPH.read_text())["spec"]["graph"]["nodes"]]


def test_graph_twin_runs_to_the_jax_analysis(tmp_path, monkeypatch):
    jman = json.loads(pathlib.Path(
        "examples/manifests/connect_graph.json").read_text())
    want = japi.Session(cluster=JCluster(devices=jax.devices()),
                        store=JObjectStore(str(tmp_path / "j"))).apply(
        jman).wait(600)
    ffn = jffn.FFNConfig(**jpipe._tupled(
        jman["spec"]["graph"]["nodes"][0]["params"]["ffn"]))
    monkeypatch.setattr(tpr, "init_params", jax_init(ffn))
    session = Session(cluster=Cluster(devices=[torch.device("cpu")]),
                      store=ObjectStore(str(tmp_path / "t")))
    h = session.apply(json.loads(GRAPH.read_text()))
    got = h.wait(600)
    assert h.state == WorkloadState.SUCCEEDED
    assert got["results"]["analyze"] == want["results"]["analyze"]
    assert got["results"]["fetch"] == want["results"]["fetch"]


@pytest.mark.parametrize("frames,lat", [(12, 40), (20, 32)])
def test_reference_tiling_leaves_the_remainder_unsegmented(tmp_path, frames,
                                                          lat):
    """``_chunk_mask`` tiles with stride = fov and drops the remainders:
    frames past the last whole fov[0] window (and lat rows past the last
    fov[1] window) stay 0 in both stacks, whatever the model says."""
    ivt = np.random.RandomState(0).rand(frames, lat, 48).astype(np.float32)
    key = "merra/ivt/chunk_00000"
    out = {}
    for name, pipe, Store, Reg, ones in (
            ("t", tpipe, ObjectStore, Registry,
             lambda x: torch.ones(np.shape(x), dtype=torch.bool)),
            ("j", jpipe, JObjectStore, JRegistry,
             lambda x: jnp.ones(np.shape(x), bool))):
        store = Store(str(tmp_path / name))
        store.put_array(f"{key}/ivt.npy", ivt)
        ctx = types.SimpleNamespace(store=store, metrics=Reg())
        cc = pipe.ConnectConfig(ffn=(tffn if name == "t" else jffn)
                                .FFNConfig(fov=(8, 16, 16)))
        assert pipe._chunk_mask(ctx, cc, ones, key) == ivt.size
        out[name] = store.get_array(f"{key}/mask.npy")
    np.testing.assert_array_equal(out["t"], out["j"])
    covered = np.zeros_like(out["t"])
    covered[:frames // 8 * 8, :lat // 16 * 16, :] = 1
    np.testing.assert_array_equal(out["t"], covered)
    assert out["t"][frames // 8 * 8:].sum() == 0


def test_example_twin_runs_and_resumes(tmp_path, capsys):
    from repro_torch.examples import connect_workflow
    argv = ["--device", "cpu", "--root", str(tmp_path)]
    out = connect_workflow.main(argv)
    assert out["results"]["analyze"]["objects"] >= 1
    assert "OK — objects tracked" in capsys.readouterr().out
    again = connect_workflow.main(argv)
    assert again["reports"] == []
    assert again["results"]["analyze"] == out["results"]["analyze"]


def test_run_connect_workflow_on_the_cpu(tmp_path, monkeypatch):
    wf, results = tpipe.run_connect_workflow(
        str(tmp_path), tpipe.connect_config(**{**KW, "n_chunks": 1}),
        device="cpu")
    assert results["inference"]["voxels"] == 8 * 32 * 48
    assert [r.step for r in wf.reports] == STEPS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_connect_workflow(str(tmp_path / "x"), TCC)


def test_full_grid_first_and_last_batches_differ_in_object_share(tmp_path):
    """``examples/connect_workflow.py --full`` asserts the last batch loss
    below the first, but at the paper-shaped grid the seed-0 draw puts
    0.15 % object voxels in the first batch and 1.08 % in the last, so
    at the initial belief (about 0.051 + 2.94 x the share) the last loss
    starts higher whatever the model (ROADMAP queue C).  Data only: the
    same windows and draws in both stacks."""
    cc = tpipe.connect_config(vol=dict(lat=361, lon=576, frames=24))
    store = ObjectStore(str(tmp_path))
    ivt, labels = tvol.generate_chunk(cc.vol, 0)
    jivt, jlabels = jvol.generate_chunk(jvol.VolumeSpec(lat=361, lon=576,
                                                         frames=24), 0)
    assert ivt.tobytes() == jivt.tobytes()
    assert labels.tobytes() == jlabels.tobytes()
    key = tvol.chunk_keys(1)[0]
    store.put_array(f"{key}/ivt.npy", ivt)
    store.put_array(f"{key}/labels.npy", labels)
    del ivt, labels, jivt, jlabels
    _, ys = tpipe.train_windows(store, cc, key)
    assert len(ys) == 735
    rng = np.random.RandomState(cc.seed)
    draws = [rng.randint(0, len(ys), cc.train_batch)
             for _ in range(120)]
    first, last = ys[draws[0]].mean(), ys[draws[-1]].mean()
    assert round(float(first), 4) == 0.0015
    assert round(float(last), 4) == 0.0108
