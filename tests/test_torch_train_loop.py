"""The port's data pipeline, checkpoints, driver and train CLI against the
JAX package, on the CPU.

* ``SyntheticLM`` and ``MemmapShards`` batches bit-equal to the
  reference's (dense, vlm with image embeddings, audio with frames; two
  hosts), and the Prefetcher's resume from a step;
* checkpoints written by JAX and restored by the port, and the reverse,
  bit-equal, with bf16 leaves and Adafactor state (the on-disk format is
  shared); atomic staging (a failed save leaves nothing), gc of old
  steps and of stale staging directories;
* an async save followed by an in-place update restores the values from
  before the update (the snapshot is a copy);
* the driver: the losses after a restart equal an uninterrupted run's
  (bit-equal: the same arithmetic on the same restored state), and an
  uninterrupted run's losses equal the JAX ``train_loop``'s from the
  same float32 weights and seed (1e-5 relative: the same float32
  arithmetic in another framework's reduction order); the watchdog;
* the CLI with ``--smoke --device cpu --steps 3``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt, optim as joptim  # noqa: E402
from repro.configs import all_archs  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.data import (DataConfig as JData, MemmapShards as JMemmap,  # noqa: E402
                        Prefetcher as JPrefetcher, SyntheticLM as JSynth)
from repro.models import model_fns as jmodel_fns  # noqa: E402
from repro.runtime import driver as jdriver  # noqa: E402
from repro_torch import bridge, checkpoint as ckpt, optim  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.data import (DataConfig, MemmapShards, Prefetcher,  # noqa: E402
                              SyntheticLM)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.runtime import driver, steps  # noqa: E402
from repro_torch.tree import named_leaves, tree_map  # noqa: E402

LOSS_RTOL = 1e-5
ARCH = "llama2-7b"
SHAPE = (16, 4)                      # seq_len, global batch


def _quiet(_):
    pass


@pytest.mark.parametrize("arch", ["llama2-7b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_batches_bit_equal(arch, hosts):
    """Every member (tokens, labels, image embeddings, frames) of the
    batches of steps 0, 1 and 17 on each host equals the reference's."""
    jcfg, tcfg = all_archs()[arch].reduced(), get_arch(arch).reduced()
    for host in range(hosts):
        j = JSynth(jcfg, JShape("t", 12, 4, "train"),
                   JData(seed=5, num_hosts=hosts, host_id=host))
        t = SyntheticLM(tcfg, ShapeSpec("t", 12, 4, "train"),
                        DataConfig(seed=5, num_hosts=hosts, host_id=host))
        for step in (0, 1, 17):
            want, got = j.batch_at(step), t.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])


def test_memmap_shards_bit_equal(tmp_path):
    """Rows of two .npy shards drawn per step and split over two hosts,
    as the reference draws them."""
    rng = np.random.RandomState(0)
    paths = []
    for i, rows in enumerate((7, 5)):
        p = tmp_path / f"shard{i}.npy"
        np.save(p, rng.randint(0, 512, (rows, 20)).astype(np.int32))
        paths.append(str(p))
    jcfg, tcfg = all_archs()[ARCH].reduced(), get_arch(ARCH).reduced()
    for host in (0, 1):
        j = JMemmap(paths, jcfg, JShape("t", 16, 4, "train"),
                    JData(seed=2, num_hosts=2, host_id=host))
        t = MemmapShards(paths, tcfg, ShapeSpec("t", 16, 4, "train"),
                         DataConfig(seed=2, num_hosts=2, host_id=host))
        for step in (0, 3):
            want, got = j.batch_at(step), t.batch_at(step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_resumes_from_a_step():
    """A Prefetcher started at step 5 yields steps 5, 6, 7 with the
    source's batches (the reference's too); stop ends its thread."""
    cfg = get_arch(ARCH).reduced()
    src = SyntheticLM(cfg, ShapeSpec("t", 16, 4, "train"), DataConfig())
    jsrc = JSynth(all_archs()[ARCH].reduced(), JShape("t", 16, 4, "train"),
                  JData())
    pf, jpf = Prefetcher(src, start_step=5), JPrefetcher(jsrc, start_step=5)
    for want_step in (5, 6, 7):
        (step, batch), (jstep, jbatch) = next(pf), next(jpf)
        assert step == jstep == want_step
        np.testing.assert_array_equal(batch["tokens"], jbatch["tokens"])
    pf.stop()
    jpf.stop()
    assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

_KIMI = {}


def _kimi_state():
    """(JAX cfg, JAX state {"params" bf16, "opt": Adafactor after one
    update}) of kimi-k2-1t-a32b reduced, cached."""
    if not _KIMI:
        jcfg = all_archs()["kimi-k2-1t-a32b"].reduced()
        params = jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
        opt = joptim.make_optimizer(jcfg, base_lr=1e-2, warmup=1)
        grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01,
                                                          p.dtype), params)
        params, state = jax.jit(opt.update)(grads, opt.init(params), params)
        _KIMI.update(cfg=jcfg, state={"params": params, "opt": state})
    return _KIMI["cfg"], _KIMI["state"]


def _equal_trees(torch_tree, jax_tree):
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jax_tree)))
    got = dict(named_leaves(torch_tree))
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A JAX checkpoint (bf16 weights, Adafactor state) restores bit-equal
    into the port's abstract (meta) template."""
    jcfg, jstate = _kimi_state()
    jckpt.save(jstate, str(tmp_path), 3)
    tcfg = get_arch("kimi-k2-1t-a32b").reduced()
    tp, to = steps.abstract_train_state(tcfg)
    assert type(optim.make_optimizer(tcfg)).__name__ == "Adafactor"
    got = ckpt.restore({"params": tp, "opt": to}, str(tmp_path))
    _equal_trees(got, jstate)
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The reverse: the port's save of the same state restores bit-equal
    in JAX (manifest, names and bf16 bits as the reference writes)."""
    jcfg, jstate = _kimi_state()
    state = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jstate),
                            "cpu")
    ckpt.save(state, str(tmp_path), 4)
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
    back = jckpt.restore(template, str(tmp_path))
    _equal_trees(state, back)
    with open(os.path.join(tmp_path, "step_4", "manifest.json")) as f:
        import json
        man = json.load(f)
    assert man["leaves"]["params/embed/w"]["dtype"] == "bfloat16"
    assert man["num_leaves"] == len(list(named_leaves(state)))


def test_atomic_staging_and_gc(tmp_path):
    """A save that fails midway leaves neither a step nor a staging
    directory; gc keeps the newest steps and sweeps stale staging."""
    good = {"a": torch.arange(6.0), "b": {"c": torch.ones(2, 2)}}

    class Boom:
        shape = (1,)

        def detach(self):
            raise OSError("disk full")
    with pytest.raises(Exception):
        ckpt.save({"a": torch.ones(3), "z": Boom()}, str(tmp_path), 1)
    assert os.listdir(tmp_path) == []
    for s in (2, 5, 9):
        ckpt.save(good, str(tmp_path), s)
    stale = tmp_path / ".staging.tmp-dead"
    stale.mkdir()
    os.utime(stale, (1, 1))
    fresh = tmp_path / ".staging.tmp-live"
    fresh.mkdir()
    ckpt.gc_old(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == [".staging.tmp-live", "step_5",
                                            "step_9"]
    back = ckpt.restore(good, str(tmp_path))
    assert torch.equal(back["a"], good["a"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"a": torch.zeros(7), "b": {"c": torch.ones(2, 2)}},
                     str(tmp_path))


def test_async_save_snapshots_before_in_place_update(tmp_path):
    """An async save, then an in-place update of the saved tensors (as
    the optimizer makes): the restored values are the ones from before
    the update."""
    cfg = get_arch(ARCH).reduced()
    params, state = steps.init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = {"params": params, "opt": state}
    before = tree_map(lambda t: t.clone(), tree)
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=1)
    saver.save(tree, 0)
    tree_map(lambda t: t.add_(1) if t.is_floating_point() else t.add_(1),
             tree)
    saver.wait()
    back = ckpt.restore(before, str(tmp_path))
    for (n, a), (_, b) in zip(named_leaves(back), named_leaves(before)):
        assert torch.equal(a, b), n
    assert saver.bytes_written == ckpt.tree_bytes(before)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _fail_once_at(step):
    state = {"done": False}

    def hook(s):
        if s == step and not state["done"]:
            state["done"] = True
            raise driver.SimulatedFailure("injected node failure")
    return hook


def test_restart_replays_the_uninterrupted_losses(tmp_path):
    """6 steps, a checkpoint every 2, a failure at step 3: the driver
    restores step 1, replays from step 2, and every loss after the
    restart equals the uninterrupted run's bit for bit; one restart."""
    cfg = get_arch(ARCH).reduced()
    shape = ShapeSpec("t", *SHAPE, "train")
    kw = dict(total_steps=6, ckpt_every=2, keep=1, print_fn=_quiet,
              device="cpu")
    plain = driver.train_loop(cfg, shape, ckpt_dir=str(tmp_path / "a"), **kw)
    crash = driver.train_loop(cfg, shape, ckpt_dir=str(tmp_path / "b"),
                              failure_hook=_fail_once_at(3), **kw)
    assert (plain.step, plain.restarts, crash.step, crash.restarts) == \
        (6, 0, 6, 1)
    assert len(crash.losses) == 7              # 0, 1, 2, then 2..5 again
    assert crash.losses[:3] == plain.losses[:3]
    assert crash.losses[3:] == plain.losses[2:]
    assert sorted(os.listdir(tmp_path / "b")) == ["step_5"]
    # steps 1, 3, 5 and the final save in both runs (the crash came
    # before step 3's save)
    state = steps.init_train_state(cfg, torch.Generator(), device="meta")
    assert crash.ckpt_bytes == plain.ckpt_bytes == 4 * ckpt.tree_bytes(
        state)


def test_driver_losses_match_jax_train_loop(tmp_path):
    """The uninterrupted port run from the reference's float32 weights
    gives the JAX train_loop's losses at the same seed (its default
    optimizer: AdamW, warmup 100)."""
    jcfg = all_archs()[ARCH].reduced().replace(dtype="float32",
                                                name="rt-test")
    tcfg = get_arch(ARCH).reduced().replace(dtype="float32")
    jres = jdriver.train_loop(jcfg, JShape("t", *SHAPE, "train"),
                              total_steps=5, ckpt_dir=str(tmp_path / "j"),
                              ckpt_every=100, print_fn=_quiet)
    jp = jax.tree_util.tree_map(
        np.asarray, jmodel_fns(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tres = driver.train_loop(
        tcfg, ShapeSpec("t", *SHAPE, "train"), total_steps=5,
        ckpt_dir=str(tmp_path / "t"), ckpt_every=100, print_fn=_quiet,
        device="cpu", init_params=lambda: tree_map(
            lambda t: t.clone(), bridge.to_torch(jp, "cpu")))
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=LOSS_RTOL)
    assert len(tres.losses) == 5


def test_straggler_watchdog():
    """The reference's watchdog rule: a step slower than threshold × the
    EWMA of the earlier ones is flagged."""
    wd = driver.StragglerWatchdog(alpha=0.5, threshold=2.0)
    jwd = jdriver.StragglerWatchdog(alpha=0.5, threshold=2.0)
    for dt in (1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.0, 1.0, 6.0):
        assert wd.observe(dt) == jwd.observe(dt)
    assert wd.flagged == jwd.flagged == 2
    assert wd.ewma == pytest.approx(jwd.ewma)


def test_train_cli_smoke_on_the_host(tmp_path, capsys):
    """``--smoke --device cpu --steps 3`` trains, saves and reports; a
    second run resumes from the saved state and trains nothing."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "done: step=3" in out and "restarts=0" in out
    assert os.listdir(tmp_path) == ["step_2"]
    train_cli.main(argv)
    out = capsys.readouterr().out
    assert "restored step 2" in out and "final_loss=none" in out


def test_train_cli_needs_a_gpu_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)])
