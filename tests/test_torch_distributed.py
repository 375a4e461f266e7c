"""PyTorch port, data-parallel training on `torch.distributed` (gloo on the
CPU): `parallel/distributed.py`, `parallel/selfcheck.py`, the data-parallel
`train/loop.train_step` and the train CLI's ``--num-processes``.

Two real processes run the self-check's dense and sparse steps at full
width on a global batch of 4; both must report the same losses, equal to one
process on the whole batch within 1e-6 relative, and that one process's loss
equals the JAX package's within 1e-5 relative (the full-width bound of
`tests/test_torch_train.py`). After each step every parameter lies within
1e-3 of the one-process run's, except the two biases in front of a batch
norm, whose gradient is zero in exact arithmetic: Adam turns their float32
residue into steps of +-lr, so their summed gradients are held to the
absolute 1e-6 bound of `tests/test_torch_train.py` instead. Smaller
two-process cases show that the synced batch-norm statistics are the
full batch's `var_mean` and that the pooled onset loss over two processes
with unequal positives equals the one-process loss. Every subprocess has
its own timeout (at most 120 s) and a free port.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from basic_pitch_torch.cli import train as t_train
from basic_pitch_torch.models import params as t_params
from basic_pitch_torch.parallel import distributed as t_dist
from basic_pitch_torch.parallel import selfcheck as t_selfcheck
from basic_pitch_torch.train import loop as t_loop
from basic_pitch_torch.train import losses as t_losses
from basic_pitch_tpu.models import nmp as j_nmp
from basic_pitch_tpu.models import params as j_params
from basic_pitch_tpu.parallel import selfcheck as j_selfcheck
from basic_pitch_tpu.train import losses as j_losses
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_train_data import write_corpus

REPO = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
GLOBAL_BATCH = 4
LOSS_RTOL = 1e-6  # two processes against one on the same global batch
JAX_LOSS_RTOL = 1e-5  # tests/test_torch_train.py, full width
PARAM_ATOL = 1e-3
PRE_BN_BIASES = ("contour_conv/b", "onset_conv/b")
PRE_BN_GRAD_ATOL = 1e-6  # tests/test_torch_train.py
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))


def _communicate(procs, timeout=TIMEOUT_S):
    """Wait for every process; a hang fails the test, and nothing is left
    running."""
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out[-4000:]
    return outs


def _two_process_case(case, tmp_path):
    port = t_selfcheck.free_port()
    outs = [tmp_path / f"{case}{rank}.npz" for rank in range(2)]
    procs = [
        subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_worker.py"), case, str(rank), "2",
                          str(port), str(outs[rank])], cwd=REPO, env=ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    _communicate(procs)
    return [dict(np.load(p)) for p in outs]


@pytest.fixture(scope="module")
def selfcheck_runs(tmp_path_factory):
    """The self-check from the JAX package's seed-0 initialization: one
    process in this process, two in subprocesses, parameters dumped."""
    d = tmp_path_factory.mktemp("selfcheck")
    flat = j_params.flatten_params(jax.device_get(j_nmp.init_params(jax.random.PRNGKey(0))))
    init = d / "init.npz"
    t_params.save_params(init, {k: np.asarray(v) for k, v in flat.items()})
    one = t_selfcheck.run(0, 1, 0, GLOBAL_BATCH, init=str(init), dump=str(d / "one.npz"))
    two = t_selfcheck.launch(2, GLOBAL_BATCH, timeout=TIMEOUT_S, env=ENV,
                             extra=["--init", str(init), "--dump", str(d / "two.npz")])
    return {"init": init, "one": one, "two": two, "one_params": dict(np.load(d / "one.npz")),
            "two_params": dict(np.load(d / "two.npz"))}


def test_synthetic_batches_are_the_jax_selfchecks():
    dense_t, dense_j = t_selfcheck.synthetic_global_batch(3), j_selfcheck.synthetic_global_batch(3)
    np.testing.assert_array_equal(dense_t["audio"], dense_j["audio"])
    for group in ("targets", "weights"):
        for key in dense_j[group]:
            np.testing.assert_array_equal(dense_t[group][key], dense_j[group][key])
    for a, b in zip(t_selfcheck.synthetic_sparse_items(2), j_selfcheck.synthetic_sparse_items(2)):
        np.testing.assert_array_equal(a["audio"], b["audio"])
        for key in b["targets"]:
            np.testing.assert_array_equal(a["targets"][key], b["targets"][key])


@pytest.mark.parametrize("kind", ["loss_dense", "loss_sparse"])
def test_two_processes_agree_and_equal_one_process(selfcheck_runs, kind):
    one, two = selfcheck_runs["one"], selfcheck_runs["two"]
    assert [r["process_count"] for r in two] == [2, 2] and one["process_count"] == 1
    assert {r["backend"] for r in two} == {"gloo"} and {r["platform"] for r in two} == {"cpu"}
    assert two[0][kind] == two[1][kind]  # the cross-process sums agreed
    assert np.isfinite(one[kind])
    np.testing.assert_allclose(two[0][kind], one[kind], rtol=LOSS_RTOL)


@pytest.mark.parametrize("step", ["dense", "sparse"])
def test_parameters_after_each_step_equal_one_process(selfcheck_runs, step):
    one, two = selfcheck_runs["one_params"], selfcheck_runs["two_params"]
    names = [k[len(step) + 1 :] for k in one if k.startswith(f"{step}/") and "/grad/" not in k]
    assert len(names) == 24
    for name in names:
        if name in PRE_BN_BIASES:
            g1, g2 = one[f"{step}/grad/{name}"], two[f"{step}/grad/{name}"]
            assert float(np.abs(g1).max()) <= PRE_BN_GRAD_ATOL and float(np.abs(g2).max()) <= PRE_BN_GRAD_ATOL, name
            continue
        err = float(np.abs(one[f"{step}/{name}"] - two[f"{step}/{name}"]).max())
        assert err <= PARAM_ATOL, (name, err)


def test_one_process_loss_equals_the_jax_step(selfcheck_runs):
    """The self-check's first step reports the loss at the initial
    parameters: the JAX package's train-mode loss on the same batch."""
    params = j_params.unflatten_params(dict(np.load(selfcheck_runs["init"])))
    batch = t_selfcheck.synthetic_global_batch(GLOBAL_BATCH)

    @jax.jit
    def loss(p):
        out, _ = j_nmp.forward(p, batch["audio"], j_nmp.DEFAULT_CONFIG, train=True)
        return j_losses.total_loss(out, batch["targets"], batch["weights"])[0]

    np.testing.assert_allclose(selfcheck_runs["one"]["loss_dense"], float(loss(params)), rtol=JAX_LOSS_RTOL)


def test_synced_batch_norm_statistics_equal_the_full_batch(tmp_path):
    ranks = _two_process_case("bn", tmp_path)
    inputs = worker.global_inputs("bn")
    var, mean = torch.var_mean(torch.from_numpy(inputs["x"]), dim=(0, 2, 3), correction=0)
    single = worker.bn_case()
    for r in ranks:
        np.testing.assert_allclose(r["mean"], mean.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["var"], var.numpy(), rtol=1e-6)
        np.testing.assert_allclose(r["gamma_grad"], single["gamma_grad"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["beta_grad"], single["beta_grad"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), single["y"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["x_grad"] for r in ranks]), single["x_grad"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["bn", "onset"])
def test_shutdown_releases_the_process_group(tmp_path, case):
    """After `distributed.shutdown` nothing holds the process group in
    either process, so its threads (gloo's loops, process 0's TCPStore
    server) have ended before the interpreter exits. A group kept alive past
    `destroy_process_group` (as by `torch.distributed.nn.functional`, whose
    defaults bind the live group when it is imported after the group
    exists) had them torn down at exit, where a process could abort."""
    for rank, r in enumerate(_two_process_case(case, tmp_path)):
        assert "pt_gloo_runloop" in r["threads_in_group"], rank  # the check sees the threads it looks for
        assert bool(r["group_released"]), rank
        assert list(r["threads_after"]) == [], (rank, r["threads_after"])


def test_pooled_onset_loss_over_two_processes_equals_one(tmp_path):
    ranks = _two_process_case("onset", tmp_path)
    single = worker.onset_case()
    for r in ranks:
        np.testing.assert_allclose(r["global"], single["share"], rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["share"] + ranks[1]["share"], single["share"], rtol=1e-6)
    for head in ("onset", "note", "contour"):
        np.testing.assert_allclose(np.concatenate([r[f"grad_{head}"] for r in ranks]), single[f"grad_{head}"],
                                   rtol=1e-5, atol=1e-12)
    # the unequal positives make a mean of per-process pooled losses wrong
    inputs = worker.global_inputs("onset")
    halves = []
    for sl in (slice(0, 2), slice(2, 4)):
        preds = {h: torch.from_numpy(inputs[f"pred_{h}"][sl]) for h in ("onset", "note", "contour")}
        targets = {h: torch.from_numpy(inputs[h][sl]) for h in ("onset", "note", "contour")}
        weights = {h: torch.from_numpy(inputs[f"w_{h}"][sl]) for h in ("onset", "note", "contour")}
        halves.append(float(t_losses.total_loss(preds, targets, weights, weighted_onset=True)[1]["onset"]))
    assert abs(np.mean(halves) - single["share"][2]) > 1e-3


def test_train_cli_two_processes_only_process_zero_writes(tmp_path):
    """``basic-pitch-torch-train --num-processes 2`` trains one epoch of one
    step on the CPU; process 1 gets an output directory of its own, which
    must stay empty."""
    # files 0-3: the loader's stable hash gives each process two of them
    source = write_corpus(tmp_path / "source", "GuitarSet", n_train=4, n_validation=1, seconds=4.0, seed=3)
    port = t_selfcheck.free_port()
    outs = [tmp_path / "out0", tmp_path / "out1"]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "basic_pitch_torch.cli.train", "--source", str(source), "--output", str(outs[k]),
             "--guitarset", "-e", "1", "--steps-per-epoch", "1", "-v", "1", "-b", "2",
             "--size-evaluation-callback-datasets", "0", "--parse-workers", "1", "--device", "cpu",
             "--num-processes", "2", "--process-id", str(k), "--coordinator", f"127.0.0.1:{port}"],
            cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for k in range(2)
    ]
    logs = _communicate(procs)
    runs = list(outs[0].iterdir())
    assert len(runs) == 1
    for name in ("model.best.npz", "checkpoints/model.00.npz", "train_state.pt"):
        assert (runs[0] / name).exists(), name
    assert not outs[1].exists() or not any(outs[1].rglob("*"))
    assert "epoch 0:" in logs[0] and "epoch 0:" not in logs[1]
    assert "process 1 of 2" in logs[1]


@pytest.mark.parametrize("flags,match", [(["-b", "3"], "must divide across 2 processes"),
                                         (["-b", "2", "--steps-per-dispatch", "2"], "single-process")])
def test_train_cli_refuses_what_does_not_split(tmp_path, flags, match):
    args = ["--source", str(tmp_path), "--output", str(tmp_path / "out"), "--guitarset", "--device", "cpu",
            "--num-processes", "2", "--coordinator", "127.0.0.1:1", *flags]
    with pytest.raises(ValueError, match=match):
        t_train.main(args)
    assert not t_dist.spans_processes()


def test_fit_refuses_stacked_batches_across_processes(tmp_path, monkeypatch):
    monkeypatch.setattr(t_dist, "spans_processes", lambda: True)
    monkeypatch.setattr(t_dist, "replicate", lambda obj, src=0: obj)
    stacked = t_loop.stack_batches([t_selfcheck.synthetic_global_batch(1)] * 2)
    config = t_loop.TrainConfig(steps_per_epoch=2, validation_steps=1, epochs=1)
    with pytest.raises(ValueError, match="single-process"):
        t_loop.fit(iter([stacked]), iter([]), tmp_path, config, device="cpu")


def test_single_process_helpers_are_no_ops():
    t_dist.initialize(None, 1, 0)
    t_dist.initialize("127.0.0.1:1", None, None)
    assert not t_dist.spans_processes() and t_dist.process_count() == 1 and t_dist.process_index() == 0
    assert t_dist.local_batch_size(5) == 5
    x = np.arange(6)
    np.testing.assert_array_equal(t_dist.local_slice({"a": x})["a"], x)
    model = torch.nn.Linear(2, 2)
    assert t_dist.replicate(model) is model
    assert t_dist.broadcast_value(1.5, "cpu") == 1.5
    t_dist.shutdown()


def test_slices_and_rendezvous(monkeypatch):
    monkeypatch.setattr(t_dist, "process_count", lambda: 2)
    monkeypatch.setattr(t_dist, "process_index", lambda: 1)
    assert t_dist.local_batch_size(4) == 2
    with pytest.raises(ValueError, match="does not divide across 2 processes"):
        t_dist.local_batch_size(3)
    tree = {"audio": np.arange(8).reshape(4, 2), "targets_sparse": {"onset": {"idx": np.arange(4), "cap": 7}}}
    sliced = t_dist.local_slice(tree)
    np.testing.assert_array_equal(sliced["audio"], [[4, 5], [6, 7]])
    assert sliced["targets_sparse"]["onset"]["idx"].tolist() == [2, 3] and sliced["targets_sparse"]["onset"]["cap"] == 7
    assert t_dist._init_method("10.0.0.1:8476") == "tcp://10.0.0.1:8476"
    assert t_dist._init_method("tcp://h:1") == "tcp://h:1"
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        t_dist._init_method("")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert t_dist._init_method(None) == "env://"
    with pytest.raises(ValueError, match="process_id"):
        t_dist.initialize("127.0.0.1:1", 2, 2)


def test_dryrun_on_the_cpu():
    """The counterpart of `__graft_entry__.dryrun_multichip(4, 2)`: two
    agreeing processes, then the int16 transcription over four devices."""
    summary = t_selfcheck.dryrun(4, 2, timeout=TIMEOUT_S)
    assert summary["events"] > 0 and np.isfinite(summary["loss_dense"])
    assert summary["max_shard_upload_bytes"] < summary["single_upload_bytes"]
