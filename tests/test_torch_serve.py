"""The port's ServeEngine and serving CLI: tokens identical to the port's
direct greedy decode and to the JAX engine on bridged parameters."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step, init_cache
from repro_torch.serve.engine import Request, ServeEngine

F32 = dict(compute_dtype="float32", param_dtype="float32")


def _setup(arch="qwen1.5-4b"):
    cfg = get_config(arch, reduced=True).replace(**F32)
    jcfg = jax_get_config(arch, reduced=True).replace(**F32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


def _direct_greedy(params, cfg, prompt, n_new):
    cache = init_cache(cfg, 1, 32, device="cpu")
    pos = torch.zeros((1,), dtype=torch.long)
    toks, nxt = [], None
    for t in prompt:
        logits, cache = decode_step(params, cfg, cache,
                                    torch.tensor([[int(t)]]), pos,
                                    device="cpu")
        pos = pos + 1
        nxt = int(torch.argmax(logits, -1)[0])
    toks.append(nxt)
    for _ in range(n_new - 1):
        logits, cache = decode_step(params, cfg, cache,
                                    torch.tensor([[toks[-1]]]), pos,
                                    device="cpu")
        pos = pos + 1
        toks.append(int(torch.argmax(logits, -1)[0]))
    return toks


def test_serve_engine_matches_direct_decode_and_reference():
    cfg, jcfg, jparams, params = _setup()
    prompt = np.array([3, 1, 4], np.int32)
    out = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                      device="cpu").serve([Request(prompt, 4)])[0].out
    assert out == _direct_greedy(params, cfg, prompt, 4)
    jout = JaxServeEngine(jcfg, jparams, batch_slots=2, max_len=32).serve(
        [JaxRequest(prompt, 4)])[0].out
    assert out == jout


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen1.5-4b", "mamba2-370m",
                                  "zamba2-1.2b"])
def test_serve_engine_batches_like_reference(arch):
    """More requests than slots, of different lengths: refills, per-slot
    positions and the max_len cut all match the JAX engine.  For the ssm
    and hybrid families this pins down the reference's recurrent-state
    handling too: every admission step steps every slot, and a refilled
    slot keeps its previous occupant's state."""
    cfg, jcfg, jparams, params = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (2, 5, 3, 4)]
    new = [3, 2, 4, 20]
    mine = ServeEngine(cfg, params, batch_slots=2, max_len=16, device="cpu")
    ref = JaxServeEngine(jcfg, jparams, batch_slots=2, max_len=16)
    got = mine.serve([Request(p, n) for p, n in zip(prompts, new)])
    want = ref.serve([JaxRequest(p, n) for p, n in zip(prompts, new)])
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    assert mine.pos.tolist() == np.asarray(ref.pos).tolist()


def test_serve_engine_runs_inside_profiler_window():
    from repro.profiler import Profiler, ProfilerOptions
    cfg, _, _, params = _setup()
    prompt = np.array([3, 1, 4], np.int32)
    want = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                       device="cpu").serve([Request(prompt, 4)])[0].out
    prof = Profiler(ProfilerOptions(insight=True))
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=32, profiler=prof,
                      device="cpu")
    assert eng.serve([Request(prompt, 4)])[0].out == want
    assert prof.report is not None and prof.report.mode == "local"


def test_serve_engine_refuses_the_tune_bind():
    from repro.profiler import Profiler, ProfilerOptions
    cfg, _, _, params = _setup()
    prof = Profiler(ProfilerOptions(insight=True, tune=True))
    with pytest.raises(NotImplementedError, match="adaptive"):
        ServeEngine(cfg, params, profiler=prof, device="cpu")


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                    "--requests", "3", "--max-new", "2", "--slots", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_serve_cli_serves_the_recurrent_families_on_cpu(capsys, arch):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--requests", "3", "--max-new", "2", "--slots", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on cpu" in out


def test_serve_cli_checkpoint_waits_for_its_slice():
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                        "--checkpoint", "ckpt"])
