"""The port's serving entry point (``repro_torch.launch.serve``) on the
CPU at the smoke size, and its refusal to fall back to the CPU.

The serving numbers of the card (full width, the flash and scan
kernels) come from chip_smoke.py; on the CPU, prefill attention and the
mamba scan take their kernels' plain versions, so no kernel launch is
counted.  The mamba serve's own CPU tests are in tests/test_torch_ssm.py.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as serve_mod  # noqa: E402

torch.set_num_threads(2)


def test_serve_smoke_on_cpu_returns_greedy_tokens_and_times():
    res = serve_mod.serve("llama3.2-3b", batch=2, prompt_len=9,
                          new_tokens=3, smoke=True, seed=0, device="cpu")
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int64
    assert bool(((res.tokens >= 0) & (res.tokens < 512)).all())
    assert res.prefill_s > 0 and len(res.decode_s) == 3
    assert all(t > 0 for t in res.decode_s)
    none = {"flash_attention": 0, "lru_scan": 0}  # CPU: plain versions
    assert res.launches == {"prefill": none, "decode": none}
    assert res.n_params == 301_536
    again = serve_mod.serve("llama3_2-3b", batch=2, prompt_len=9,
                            new_tokens=3, smoke=True, seed=0, device="cpu")
    assert torch.equal(again.tokens, res.tokens)  # seeded end to end


def test_serve_tokens_are_the_greedy_decode_of_the_steps():
    """The driver's tokens are what the model's own steps give."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as tm
    res = serve_mod.serve(batch=1, prompt_len=6, new_tokens=2, seed=3,
                          device="cpu")
    cfg = smoke_config("llama3.2-3b")
    gen = torch.Generator().manual_seed(3)
    model = tm.init_model(cfg, gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (1, 6), generator=gen)
    logits, _ = tm.make_prefill_step(cfg)(model, {"tokens": prompts})
    assert int(res.tokens[0, 0]) == int(torch.argmax(logits[0, -1]))


def test_main_runs_on_cpu_when_asked(capsys):
    res = serve_mod.main(["--device", "cpu", "--batch", "1",
                          "--prompt-len", "5", "--new-tokens", "2"])
    assert res.tokens.shape == (1, 3)
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b" in out and "ms/step" in out


def test_main_raises_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import smoke_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_mod.main(["--batch", "1", "--prompt-len", "4",
                        "--new-tokens", "1"])
    with pytest.raises(ValueError, match="not yet ported"):
        serve_mod.serve("no-such-arch", device="cpu")
    # a softcapped config serves on the CPU (the flash kernel's plain
    # version takes the cap)
    res = serve_mod.serve(smoke_config("qwen2-vl-2b").scaled(
        attn_logit_softcap=50.0), batch=1, prompt_len=4, new_tokens=1,
        device="cpu")
    assert res.tokens.shape == (1, 2)
    assert res.launches["prefill"]["flash_attention"] == 0
