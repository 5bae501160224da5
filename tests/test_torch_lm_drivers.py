"""The port's transformer drivers and training checkpoints against the JAX
package's: ``launch/train.py`` resuming a JAX checkpoint, checkpoints read
by either store, and ``launch/serve.py``'s greedy tokens.

Tolerances: resumed losses as printed (4 decimals) within 2e-4 of the JAX
driver's printed losses (1e-4 of rounding, the rest float32 order); the
learning rates as printed, equal; restored leaves, and greedy tokens (argmax
of logits that agree within 2e-5, tests/test_torch_transformer.py), equal.
"""
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import lm as jlm
from repro.launch import train as jtrain
from repro.models.recsys import fm as jfm
from repro.models.transformer import model as jm
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_train_state
from repro_torch import interop
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import lm as tlm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.recsys import fm as tfm
from repro_torch.models.transformer import model as tm
from repro_torch.training import AdamWConfig, init_train_state

REPO = Path(__file__).resolve().parents[1]
STEP_LINE = re.compile(r"step\s+(\d+) loss ([\d.]+) lr (\S+) gnorm ([\d.]+)")
TRAIN_FLAGS = ["--arch", "gemma2-2b", "--reduced", "--steps", "4", "--batch",
               "2", "--seq", "32", "--log-every", "1"]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO / "src"),
            "JAX_PLATFORMS": "cpu"}


def _steps(text):
    return {int(m[1]): (float(m[2]), m[3], float(m[4]))
            for m in STEP_LINE.finditer(text)}


def test_port_resumes_a_jax_training_checkpoint(tmp_path, capsys):
    """The JAX driver trains 4 steps and checkpoints at 2 and 4; the port's
    driver resumes the step-2 checkpoint and prints steps 3 and 4 as the
    JAX driver printed them."""
    jdir = tmp_path / "jax"
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *TRAIN_FLAGS,
         "--ckpt-dir", str(jdir), "--ckpt-every", "2"],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _steps(proc.stdout)
    assert sorted(want) == [1, 2, 3, 4]
    tdir = tmp_path / "port"
    shutil.copytree(jdir / "step_0000000002", tdir / "step_0000000002")
    out = ttrain.main([*TRAIN_FLAGS, "--ckpt-dir", str(tdir), "--resume",
                       "--device", "cpu", "--ckpt-every", "2"])
    text = capsys.readouterr().out
    assert "resumed at step 2" in text
    assert text.splitlines()[0] == proc.stdout.splitlines()[0]  # arch line
    got = _steps(text)
    assert sorted(got) == [3, 4] and len(out["losses"]) == 2
    for step in (3, 4):
        assert abs(got[step][0] - want[step][0]) <= 2e-4, (step, got, want)
        assert got[step][1] == want[step][1]
        assert abs(got[step][2] - want[step][2]) <= 0.011
    # the port's step-4 checkpoint restores in the JAX store
    jcfg = jlm.reduced(jlm.LM_CONFIGS["gemma2-2b"])
    opt = JAdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=4)
    template = j_init_train_state(jm.init_params(jcfg, jax.random.PRNGKey(9)), opt)
    jstate, meta = jstore.restore(str(tdir), template)
    assert meta["step"] == 4 and meta["filled_from_template"] == []
    assert int(jstate.opt.step) == 4
    jstate4, _ = jstore.restore(str(jdir), template)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params),
                    jax.tree_util.tree_leaves(jstate4.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)


def test_bf16_training_resumes_through_the_driver(tmp_path, capsys):
    """``--dtype bfloat16``: the reduced gemma2-2b trains 4 steps with
    checkpoints at 2 and 4; the step-4 checkpoint restores into a fresh
    template bit for bit, leaf by leaf (bfloat16 kept); ``--resume`` from
    step 2 prints steps 3 and 4 with the uninterrupted run's losses, bit
    for bit (the same ops on the same host)."""
    flags = [*TRAIN_FLAGS, "--dtype", "bfloat16", "--device", "cpu",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = ttrain.main(flags)
    cfg = dataclasses.replace(tlm.reduced(tlm.LM_CONFIGS["gemma2-2b"]),
                              dtype="bfloat16")
    template = init_train_state(
        tm.init_params(cfg, torch.Generator().manual_seed(5), "cpu"),
        AdamWConfig(lr_peak=3e-3, warmup_steps=5, total_steps=4))
    restored, meta = tstore.restore(str(tmp_path), template)
    assert meta["step"] == 4 and meta["filled_from_template"] == []
    want, got = _port_leaves(first["state"]), _port_leaves(restored)
    assert sorted(got) == sorted(want)
    assert any(v.dtype == np.dtype("V2") for v in got.values())
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert want[k].tobytes() == got[k].tobytes(), k
    shutil.rmtree(tmp_path / "step_0000000004")
    capsys.readouterr()
    again = ttrain.main([*flags, "--resume"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert again["losses"] == first["losses"][2:]


def test_synthetic_batches_equal_jax():
    for step in range(3):
        rng_j, rng_t = (np.random.default_rng((0 << 20) + step) for _ in range(2))
        jb = jtrain.synthetic_lm_batch(rng_j, 3, 17, 512)
        tb = ttrain.synthetic_lm_batch(rng_t, 3, 17, 512, device="cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def _bump(x):
    """x + 0.5 for a float leaf, + 1 for the step, each in its dtype."""
    return x + jnp.asarray(0.5 if jnp.issubdtype(x.dtype, jnp.floating) else 1,
                           x.dtype)


def _lm_states(name="mixtral-8x7b"):
    jcfg = jlm.reduced(jlm.LM_CONFIGS[name])
    tcfg = tlm.reduced(tlm.LM_CONFIGS[name])
    jstate = j_init_train_state(jm.init_params(jcfg, jax.random.PRNGKey(2)),
                                JAdamWConfig())
    # moments and step made nonzero, so a mixed-up leaf shows
    jstate = jax.tree.map(_bump, jstate)
    tstate = init_train_state(tm.init_params(
        tcfg, torch.Generator().manual_seed(1), "cpu"), AdamWConfig())
    return jstate, tstate


def _fm_states():
    cfg = tfm.FMConfig(total_vocab=5_000, n_fields=7)
    jcfg = jfm.FMConfig(total_vocab=5_000, n_fields=7)
    jstate = j_init_train_state(jfm.init_params(jcfg, jax.random.PRNGKey(3)),
                                JAdamWConfig())
    jstate = jax.tree.map(_bump, jstate)
    tparams = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              requires_grad=True)
    return jstate, init_train_state(tparams, AdamWConfig())


def _port_leaves(state):
    return tstore._flatten(state)


def _jax_leaves(state):
    return {"/".join(str(k) for k in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(state)[0]}


@pytest.mark.parametrize("states", [_lm_states, _fm_states], ids=["lm", "fm"])
def test_training_checkpoints_restore_in_either_store(tmp_path, states):
    jstate, tstate = states()
    # JAX writes, the port restores
    jstore.save(str(tmp_path / "j"), 7, jstate)
    restored, meta = tstore.restore(str(tmp_path / "j"), tstate)
    assert meta["step"] == 7 and meta["filled_from_template"] == []
    got, want = _port_leaves(restored), _jax_leaves(jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the port writes, JAX restores (into a template of zeros)
    tstore.save(str(tmp_path / "t"), 8, restored)
    back, meta = jstore.restore(str(tmp_path / "t"),
                                jax.tree.map(jnp.zeros_like, jstate))
    assert meta["filled_from_template"] == []
    for k, v in _jax_leaves(back).items():
        np.testing.assert_array_equal(v, want[k])
    # interop carries the same state without a file
    again = interop.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         states()[1])
    for k, v in _port_leaves(again).items():
        np.testing.assert_array_equal(v, want[k])


def test_bf16_leaves_are_written_as_jax_writes_them(tmp_path):
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16), "s": jnp.int32(3)}
    ttree = {"w": torch.as_tensor(vals).bfloat16(),
             "s": torch.tensor(3, dtype=torch.int32)}
    jstore.save(str(tmp_path / "j"), 1, jtree)
    tstore.save(str(tmp_path / "t"), 1, ttree)
    loaded = []
    for side in ("j", "t"):
        path = tmp_path / side / "step_0000000001" / "leaves.npz"
        with zipfile.ZipFile(path) as z:
            assert sorted(z.namelist()) == ["['s'].npy", "['w'].npy"]
        with np.load(path) as data:
            loaded.append({k: data[k] for k in data.files})
    # any reader gets the same arrays: raw 2-byte words, the same dtype
    for k in ("w", "s"):
        a, b = loaded[0][f"['{k}']"], loaded[1][f"['{k}']"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert loaded[0]["['w']"].dtype == np.dtype("V2")
    template = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                "s": torch.tensor(0, dtype=torch.int32)}
    got, _ = tstore.restore(str(tmp_path / "j"), template)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], ttree["w"])
    assert int(got["s"]) == 3


def test_bf16_params_carry_across_bit_for_bit():
    jcfg = dataclasses.replace(jlm.reduced(jlm.LM_CONFIGS["gemma2-2b"]),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(tlm.reduced(tlm.LM_CONFIGS["gemma2-2b"]),
                               dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = interop.lm_params_from_jax(tcfg, jp, device="cpu")
    want = _jax_leaves(jp)
    for k, v in _port_leaves(tp).items():
        assert v.dtype == np.dtype("V2")
        np.testing.assert_array_equal(v.view(np.int16), want[k].view(np.int16))


def _jax_greedy(jcfg, jp, prompts, gen):
    """The JAX serve driver's greedy loop on given weights and prompts."""
    cache = jm.init_cache(jcfg, prompts.shape[0], prompts.shape[1] + gen,
                          dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, c: jm.prefill(jcfg, p, t, c))
    decode = jax.jit(lambda p, t, c: jm.decode_step(jcfg, p, t, c))
    logits, cache = prefill(jp, jnp.asarray(prompts), cache)
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    out = []
    for _ in range(gen):
        out.append(np.asarray(nxt)[:, 0])
        logits, cache = decode(jp, nxt, cache)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(out, 1)


@pytest.mark.parametrize("name", sorted(jlm.LM_CONFIGS))
def test_serve_greedy_tokens_equal_jax(name):
    jcfg = jlm.reduced(jlm.LM_CONFIGS[name])
    tcfg = tlm.reduced(tlm.LM_CONFIGS[name])
    jp = jm.init_params(jcfg, jax.random.PRNGKey(5))
    tp = interop.lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                    device="cpu", requires_grad=False)
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab, (4, 12)).astype(np.int32)
    got = tserve.generate(tcfg, tp, torch.as_tensor(prompts), 8)
    np.testing.assert_array_equal(got["tokens"], _jax_greedy(jcfg, jp, prompts, 8))


def test_serve_cli_prints_the_jax_drivers_lines(capsys):
    out = tserve.main(["--arch", "grok-1-314b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill: 2x8 tokens in [\d.]+ ms", lines[0])
    assert re.fullmatch(r"decode: 5 steps x batch 2 in [\d.]+ ms \([\d,]+ tok/s\)",
                        lines[1])
    assert lines[2] == f"sample token ids: {out['tokens'][0][:12].tolist()}"
    sampled = tserve.main(["--arch", "grok-1-314b", "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen", "5",
                           "--temperature", "0.7"])
    again = tserve.main(["--arch", "grok-1-314b", "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "8", "--gen", "5",
                         "--temperature", "0.7"])
    assert np.array_equal(sampled["tokens"], again["tokens"])  # seeded sampler
    assert ((sampled["tokens"] >= 0) & (sampled["tokens"] < 512)).all()


@pytest.mark.parametrize("module", ["serve", "train"])
def test_drivers_default_to_cuda_and_refuse_without_a_card(module):
    mod = {"serve": tserve, "train": ttrain}[module]
    assert mod.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver runs on it")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        mod.main(["--reduced"])


def _smoke(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.smoke",
                           *args], capture_output=True, text=True, env=env,
                          timeout=120)


def test_smoke_runs_the_lm_family_and_refuses_only_gnns():
    """The GNNs are ported now: they run beside the LMs, and the smoke
    refuses only a name it does not know."""
    ok = _smoke("--arch", "mixtral-8x7b", "--device", "cpu")
    assert ok.returncode == 0 and "[smoke OK] mixtral-8x7b" in ok.stdout
    gnn = _smoke("--arch", "equiformer-v2", "--device", "cpu")
    assert gnn.returncode == 0, gnn.stderr
    assert "[smoke OK] equiformer-v2" in gnn.stdout
    no = _smoke("--arch", "llama-unknown", "--device", "cpu")
    assert no.returncode != 0 and "invalid choice" in no.stderr


def test_smoke_all_runs_every_architecture_on_cpu():
    from repro_torch.launch import smoke

    proc = _smoke("--all", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    names = [line.split()[2] for line in proc.stdout.splitlines()
             if line.startswith("[smoke OK]")]
    assert names == sorted(smoke.FAMILIES) and len(names) == 10
    assert {"fm", "gatedgcn", "graphcast", "nequip", "equiformer-v2",
            "gemma2-2b", "internlm2-20b", "gemma3-27b", "mixtral-8x7b",
            "grok-1-314b"} == set(names)
    both = _smoke("--all", "--arch", "fm", "--device", "cpu")
    assert both.returncode != 0 and "not allowed with" in both.stderr
    neither = _smoke("--device", "cpu")
    assert neither.returncode != 0 and "one of the arguments" in neither.stderr
