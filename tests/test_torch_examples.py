"""The last five example twins on the CPU: ``repro_torch.examples.{
quickstart, train_lm, serve_lm, elastic_failover, graph_workflow}`` with
``--device cpu`` at their smallest runs, each making its JAX original's
checks (``examples/*.py``) and printing its report line.  Each training
run is a new thread with its own OpenMP team, so torch is pinned to two
threads, as in the other threaded test files."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_quickstart_twin_trains_and_serves(capsys):
    """The manifest round-trips, the loss falls, both workloads Succeed."""
    from repro_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert len(out["results"]) == 6
    assert "TrainJob" in text and "ServeJob" in text and "loss:" in text


def test_train_lm_twin_self_heals_an_injected_crash(capsys):
    """``--resume-demo`` at 8 steps: the crash at step 4 is retried within
    the one apply, a loss for every step, the last below the first."""
    from repro_torch.examples import train_lm
    out = train_lm.main(["--device", "cpu", "--steps", "8",
                         "--resume-demo"])
    assert len(out["losses"]) == 8
    outcomes = [seg.outcome for seg in out["report"].segments]
    assert outcomes == ["error", "done"], outcomes
    assert "first-loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "kimi-k2-1t-a32b"])
def test_serve_lm_twin_serves_every_request(arch, capsys):
    """The mixed stop lengths (12, 3, 6, 3) on 4 slots: every request
    served with its stop length, on phi4 and on kimi-k2's smoke config."""
    from repro_torch.examples import serve_lm
    out = serve_lm.main(["--device", "cpu", "--arch", arch])
    got = out["results"]
    assert [len(got[i]) for i in range(8)] == [12, 3, 6, 3] * 2
    assert f"served 8 requests on {arch}" in capsys.readouterr().out


def test_elastic_failover_twin_shrinks_and_grows_the_plan(capsys):
    """8 logical slots: two fail and rejoin, the plan goes (4, 2) -> (2, 2)
    -> (4, 2) with the accumulation doubled on (2, 2), a loss every step."""
    from repro_torch.examples import elastic_failover
    out = elastic_failover.main(["--fast", "--device", "cpu"])
    shapes = [s.mesh_shape for s in out["report"].segments]
    assert shapes[0] == (4, 2) and (2, 2) in shapes and shapes[-1] == (4, 2)
    text = capsys.readouterr().out
    assert "CHURN_REPORT " in text and "OK: self-healed" in text


def test_graph_workflow_twin_fans_out_cancels_and_resumes(capsys):
    """The port's graph manifest across 3 sites: a straight run, a cancel
    after the first segment branch, a resume that runs only the rest."""
    from repro_torch.examples import graph_workflow
    rep = graph_workflow.main(["--fast", "--device", "cpu"])
    assert rep["n_chunks"] == 3
    assert sorted(rep["cancelled_after"] + rep["resumed"]) == [0, 1, 2]
    assert "GRAPH_REPORT " in capsys.readouterr().out
