"""The port's benchmark (lstc_vad_tpu_torch/benchmark.py) against the JAX
package's (lstc_vad_tpu/benchmark.py): the same contract keys and FLOP
count, the same measured function on the same weights, the outage
behaviour with CUDA's markers in place of XLA's, and a whole run at tiny
width on the CPU (its numbers are CPU numbers: only the line's shape is
checked).  The measured function is held at tests/test_encoder_parity.py's
tolerance.
"""

import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from lstc_vad_tpu import benchmark as jax_benchmark
from lstc_vad_tpu.config import preset as jax_preset
from lstc_vad_tpu_torch import benchmark, cli
from lstc_vad_tpu_torch.ckpt.interop import state_dict_from_jax
from lstc_vad_tpu_torch.config import preset as port_preset

# 2 layers, d_model 32, 2 heads: the benchmark's configs cut to a tiny width
TINY = {"encoder.d_model": 32, "encoder.d_inner": 48, "encoder.n_head": 2,
        "encoder.d_k": 16, "encoder.d_v": 16, "encoder.n_layers": 2,
        "head.d_model": 32, "head.hidden_dim": 16, "data.d_model": 32}
# every phase's size shrunk so that the whole run takes seconds
TINY_SIZES = {
    "FLAGSHIP_VIDEOS": 2, "FLAGSHIP_CLIPS": 12, "FLAGSHIP_BATCH": 4,
    "REF_PARTS": 3, "STN_ROWS": 8, "STN_BATCH": 4, "UBNORMAL_ROWS": 4,
    "UBNORMAL_BATCH": 2, "UCF_VIDEOS": 2, "UCF_CLIPS": 40, "UCF_SWEEPS": 1,
    "HOSTFED_VIDEOS": 2, "HOSTFED_CLIPS": 10, "HOSTFED_SWEEPS": 1,
    "H2D_SHAPE": (4, 64, 64), "SERVING_STREAMS": 2, "SERVING_FLUSHES": 3,
    "SERVING_MP_ROWS": 2, "SERVING_MP_CALLS": 3, "SERVING_MP_MAX_BATCH": 4,
    "TRAIN_WARM": 1, "TRAIN_STEPS": 1}
BUSY = "CUDA error: CUDA-capable device(s) is/are busy or unavailable"
NO_CARD = "CUDA error: no CUDA-capable device is detected"


def _stdout_json_lines(capsys):
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines, [json.loads(ln) for ln in lines]


def test_contract_keys_are_the_jax_benchmarks():
    assert benchmark.CONTRACT_KEYS == jax_benchmark.CONTRACT_KEYS


@pytest.mark.parametrize("name", ["sht_ltn", "sht_stn", "ubnormal_ltn",
                                  "ucf_ltn"])
def test_flop_count_matches_jax(name):
    jcfg, pcfg = jax_preset(name), port_preset(name)
    d = pcfg.data
    for length in (d.n_patch + 1, d.part_len * d.n_patch + 1):
        assert benchmark.flops_per_tokens(pcfg, length) == \
            jax_benchmark.flops_per_tokens(jcfg, length)
    assert benchmark.flops_per_part(pcfg) == \
        jax_benchmark.flops_per_part(jcfg)


@pytest.mark.parametrize("name", ["sht_ltn", "sht_stn"])
def test_measured_apply_matches_jax(name):
    """The port's measured function (models.build + _scorer_apply) on the
    JAX _build_apply's weights gives its scores: probs[:, 1] of the
    classifier (sht_ltn), out[:, 0] of the regressor (sht_stn)."""
    jcfg = jax_preset(name, **TINY)
    _, _, params, jax_apply = jax_benchmark._build_apply(jcfg)
    params = jax.tree.map(np.asarray, params)
    pcfg = port_preset(name, **TINY)
    encoder, head, apply = benchmark._build_apply(pcfg, device="cpu")
    enc_sd, head_sd = state_dict_from_jax(params["encoder"], params["head"],
                                          pcfg.encoder, pcfg.head.kind)
    encoder.load_state_dict(enc_sd, strict=True)
    head.load_state_dict(head_sd, strict=True)
    d = pcfg.data
    tokens = d.n_patch if name.endswith("stn") else d.part_len * d.n_patch
    x = np.random.default_rng(0).standard_normal(
        (6, tokens, d.d_model)).astype(np.float32)
    want = np.asarray(jax_apply(params, x))
    got = apply(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# --- outage behaviour: tests/test_benchmark_outage.py's cases ------------

def test_outage_prints_single_explicit_json_line(capsys):
    """Card unreachable on both probes: one parseable line with every
    contract key null but metric and unit, the transient_outage marker,
    and exit code 1."""
    rc = benchmark.main(retry_wait_s=0.0, probe=lambda: (False, NO_CARD),
                        runner=lambda: pytest.fail("runner must not start"))
    assert rc == 1
    lines, parsed = _stdout_json_lines(capsys)
    assert len(lines) == 1
    (rec,) = parsed
    assert rec["metric"] == "sht_ltn_eval_snippets_per_sec"
    assert rec["unit"] == "snippets/s"
    assert rec["transient_outage"] is True
    assert "no CUDA-capable device" in rec["outage_detail"]
    assert not set(benchmark.CONTRACT_KEYS) - set(rec)
    assert all(rec[k] is None for k in benchmark.CONTRACT_KEYS
               if k not in ("metric", "unit"))


def test_probe_blip_recovers_and_runs(capsys):
    results = iter([(False, "blip"), (True, "")])
    ran = []
    rc = benchmark.main(retry_wait_s=0.0, probe=lambda: next(results),
                        runner=lambda: ran.append(1))
    assert ran == [1] and rc == 0
    assert capsys.readouterr().out == ""  # the runner owns the JSON line


def test_midrun_transient_after_reexec_prints_outage(capsys, monkeypatch):
    """A transient error in the re-executed process with the card confirmed
    unreachable: the outage line, exit code 1."""
    monkeypatch.setenv(benchmark.RETRY_ENV, "1")
    probes = iter([(True, ""), (False, NO_CARD)])

    def runner():
        raise RuntimeError(BUSY)

    rc = benchmark.main(retry_wait_s=0.0, probe=lambda: next(probes),
                        runner=runner)
    assert rc == 1
    lines, parsed = _stdout_json_lines(capsys)
    assert len(lines) == 1
    assert parsed[0]["transient_outage"] is True
    assert "busy or unavailable" in parsed[0]["outage_detail"]


def test_persistent_transient_on_reachable_card_raises(monkeypatch):
    monkeypatch.setenv(benchmark.RETRY_ENV, "1")

    def runner():
        raise RuntimeError(BUSY)

    with pytest.raises(RuntimeError, match="busy or unavailable"):
        benchmark.main(retry_wait_s=0.0, probe=lambda: (True, ""),
                       runner=runner)


@pytest.mark.parametrize("retried", [False, True])
@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("attention kernel launch failed: CUDA-capable device(s) "
                 "is/are busy or unavailable (cudaError 46, f32, B=1024 H=8 "
                 "L=49 d_k=256 d_v=256 torch.float32)"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory on HBM"),
    ValueError("genuine bug")], ids=["oom", "kernel", "xla_marker", "bug"])
def test_program_faults_always_raise(monkeypatch, capsys, retried, error):
    """Running out of device memory, a kernel's error (even one carrying a
    transient CUDA string) and XLA's markers are faults of the program:
    they raise on a reachable card, never re-exec, never print a line."""
    if retried:
        monkeypatch.setenv(benchmark.RETRY_ENV, "1")
    else:
        monkeypatch.delenv(benchmark.RETRY_ENV, raising=False)
    calls = []
    monkeypatch.setattr(os, "execv", lambda exe, argv: calls.append(argv))

    def runner():
        raise error

    with pytest.raises(type(error)):
        benchmark.main(retry_wait_s=0.0, probe=lambda: (True, ""),
                       runner=runner)
    assert calls == []
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("message", [BUSY, NO_CARD])
def test_midrun_transient_reexecs_interpreter_by_abspath(monkeypatch,
                                                         message):
    monkeypatch.delenv(benchmark.RETRY_ENV, raising=False)
    calls = []
    monkeypatch.setattr(os, "execv",
                        lambda exe, argv: calls.append((exe, argv)))

    def runner():
        raise RuntimeError(message)

    benchmark.main(retry_wait_s=0.0, probe=lambda: (True, ""), runner=runner)
    assert calls and calls[0][0] == sys.executable
    assert calls[0][1][0] == sys.executable
    assert os.environ.get(benchmark.RETRY_ENV) == "1"
    assert os.environ.get("LSTC_BENCH_RETRY") is None  # the JAX one's


def test_probe_reports_no_card_here():
    """The probe runs in a fresh interpreter; without a card it reports
    not reachable, with the child's error."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    ok, detail = benchmark._probe_device(timeout_s=120.0)
    assert not ok and detail


def test_cli_benchmark_takes_no_option_and_returns_the_exit_code(
        monkeypatch):
    monkeypatch.setattr(benchmark, "main", lambda: 1)
    assert cli.main(["benchmark"]) == 1
    with pytest.raises(SystemExit):
        cli.main(["benchmark", "--device", "cpu"])


# --- a whole run at tiny width on the CPU --------------------------------

def test_tiny_cpu_run_prints_one_contract_line(monkeypatch, capsys):
    monkeypatch.setattr(benchmark, "preset",
                        lambda name, **kw: port_preset(
                            name, **TINY, **{"data.batch_size": 2}, **kw))
    for name, value in TINY_SIZES.items():
        assert hasattr(benchmark, name), name
        monkeypatch.setattr(benchmark, name, value)
    benchmark._run("cpu")
    captured = capsys.readouterr()
    lines = [ln for ln in captured.out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert tuple(rec) == benchmark.CONTRACT_KEYS
    assert rec["metric"] == "sht_ltn_eval_snippets_per_sec"
    assert rec["unit"] == "snippets/s"
    assert rec["train_compute_dtype"] == "float32"
    for key, value in rec.items():
        if key in ("metric", "unit", "train_compute_dtype"):
            continue
        assert isinstance(value, float) and math.isfinite(value) \
            and value > 0, (key, value)
    assert rec["serving_flush_p50_ms"] <= rec["serving_flush_p99_ms"]
    # the CPU runs the plain attention: no kernel launched, and the
    # summary names the CPU, never a card
    launches = [ln for ln in captured.err.splitlines()
                if ln.startswith("benchmark launches ")]
    assert len(launches) == 1
    counts = json.loads(launches[0][len("benchmark launches "):])
    assert set(counts) == {"f32", "bf16", "f32_stream", "bf16_stream"}
    assert not any(counts.values())
    assert "on cpu (no card)" in captured.err
