"""Serving every decoder-only family of the port against the JAX package
(the companion of ``tests/test_torch_families.py``, whose configs, inputs
and tolerances it uses): greedy ``generate`` per family, the raises of the
pad-mask prefill on stacks with ring, recurrent or SSM state, M-RoPE's
default streams, the serve CLI for every family, and the port's configs
equal to the JAX package's, whisper's included (whisper against JAX:
``tests/test_torch_whisper.py``).  Recurrent and SSM state through budgets, splices and the
batcher: ``tests/test_torch_families_state.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
from repro.serve.engine import ServeConfig as JServe, generate as j_generate
import repro_torch.configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.models import init_params, prefill, transformer
from repro_torch.serve import ServeConfig, generate, prefill_one
from test_torch_families import B, FAMILIES, NOT_FULL, PROMPT, T, TOL_AX, _batch, _cfgs, _np


@pytest.fixture(scope="module", params=FAMILIES)
def fam(request):
    name = request.param
    jc, tc = _cfgs(name)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.device_get(jp), tc, device="cpu")
    S = PROMPT.get(name, 16)
    jb, tb = _batch(jc, S)
    return dict(name=name, jc=jc, tc=tc, jp=jp, tp=tp, S=S, jb=jb, tb=tb)


def _margins(jp, jc, batch, jt, S):
    """JAX's top-2 margins along its own greedy tokens."""
    if "tokens" in batch:
        seq = jnp.concatenate([batch["tokens"], jnp.asarray(jt[:, :-1])], axis=1)
        jl, _ = jax.jit(lambda p, b: JM.prefill(p, b, jc, max_cache_len=S + T))(
            jp, {"tokens": seq})
        lg = _np(jl)[:, S - 1:]
        top2 = np.sort(lg, axis=-1)[..., -2:]
        return top2[..., 1] - top2[..., 0]
    return None


def test_greedy_generate_equals_jax(fam):
    jc, tc, S = fam["jc"], fam["tc"], fam["S"]
    jt = np.asarray(j_generate(fam["jp"], fam["jb"], jc, JServe(max_new_tokens=T)))
    tt = generate(fam["tp"], fam["tb"], tc, ServeConfig(max_new_tokens=T))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (B, T)
    if np.array_equal(jt, tt.numpy()):
        return
    margin = _margins(fam["jp"], jc, fam["jb"], jt, S)
    assert margin is not None, (jt, tt)
    for b in range(B):
        for t in range(T):
            if tt[b, t].item() != jt[b, t]:
                assert margin[b, t] <= TOL_AX, (b, t, margin[b, t])
                break


@pytest.mark.parametrize("name", NOT_FULL)
def test_pad_mask_prefill_raises_on_stacks_with_state(name):
    """The pad-mask prefill and everything built on it raise on a stack with
    ring, recurrent or SSM state, as JAX asserts."""
    jc, tc = _cfgs(name)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = init_params(tc, seed=0, device="cpu")
    S = 32
    toks = np.ones((B, S), np.int32)
    lens = np.array([S, S - 5], np.int32)
    with pytest.raises(AssertionError, match="full-attention"):
        JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, max_cache_len=S + 4,
                   prompt_lens=jnp.asarray(lens))
    with pytest.raises(ValueError, match="full-attention"):
        prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, max_cache_len=S + 4,
                prompt_lens=torch.from_numpy(lens))
    with pytest.raises(ValueError, match="full-attention"):
        generate(tp, {"tokens": torch.from_numpy(toks)}, tc, ServeConfig(max_new_tokens=3),
                 prompt_lens=lens)
    with pytest.raises(ValueError, match="full-attention"):
        prefill_one(tp, torch.from_numpy(toks[:1]), S - 5, tc, max_cache_len=S + 4)
    if "local" in tc.layer_kinds():
        # the ring's own guard, below the stack's
        from repro_torch.models.layers import attn_apply, make_rope

        x = torch.zeros((1, 4, tc.d_model))
        pos = torch.arange(4)[None]
        with pytest.raises(ValueError, match="ring"):
            attn_apply(tp["layers"][tc.layer_kinds().index("local")]["attn"], x, tc, pos=pos,
                       inv_freq=make_rope(tc.head_dim_, tc.rope_theta),
                       window=tc.local_window, mode="prefill", max_cache_len=8,
                       prompt_lens=torch.tensor([3]))


def test_vlm_positions_default_to_three_equal_streams():
    """Without ``pos`` the vlm's positions are arange on all three M-RoPE
    streams (decode broadcasts the cache index the same way, as JAX does):
    explicit equal streams give the same logits, distinct ones others."""
    jc, tc = _cfgs("qwen2-vl-72b")
    tp = init_params(tc, seed=1, device="cpu")
    emb = torch.randn((B, 6, tc.d_model), generator=torch.Generator().manual_seed(0))
    t = torch.arange(6)[None].expand(B, 6)
    with torch.inference_mode():
        a, _ = transformer.forward(tp, {"embeds": emb, "pos": t[..., None].expand(B, 6, 3)},
                                   tc, mode="train")
        b, _ = transformer.forward(tp, {"embeds": emb}, tc, mode="train")
        c, _ = transformer.forward(tp, {"embeds": emb, "pos": torch.stack(
            [t, t // 2, t % 2], -1)}, tc, mode="train")
    assert torch.equal(a, b) and not torch.allclose(a, c)


def test_whisper_is_refused_until_its_slice():
    """Whisper's slice is in: the port's ARCHS equal the JAX package's,
    config for config and reduced config for reduced config, and whisper's
    ``init_params`` runs (its two stacks as lists)."""
    assert list(TC.ARCHS) == list(JC.ARCHS) and "whisper-base" in TC.ARCHS
    assert TC.LONG_CONTEXT_OK == JC.LONG_CONTEXT_OK
    for n, c in TC.ARCHS.items():
        assert dataclasses.asdict(c) == dataclasses.asdict(JC.ARCHS[n])
        assert dataclasses.asdict(TC.reduced(c)) == dataclasses.asdict(JC.reduced(JC.ARCHS[n]))
    cfg = TC.reduced(TC.ARCHS["whisper-base"])
    p = init_params(cfg, device="cpu")
    assert len(p["layers_enc"]) == cfg.n_enc_layers == 2
    assert len(p["layers_dec"]) == cfg.n_layers
    assert p["embed"]["w"].shape == (cfg.padded_vocab, cfg.d_model)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_cli_takes_every_family(name, capsys):
    """``python -m repro_torch.launch.serve --arch <family> --device cpu``;
    with the first family, the encoder-decoder too."""
    from repro_torch.launch import serve

    out, _ = serve.main(["--arch", name, "--device", "cpu", "--smoke", "--ax", "--batch", "2",
                         "--prompt-len", "16", "--new-tokens", "3"])
    assert out.shape == (2, 3)
    assert f"arch={name}-smoke generated 6 tokens" in capsys.readouterr().out
    if name != FAMILIES[0]:
        return
    out, _ = serve.main(["--arch", "whisper-base", "--device", "cpu", "--smoke", "--ax",
                         "--batch", "2", "--prompt-len", "16", "--new-tokens", "2"])
    assert out.shape == (2, 2)
    assert "arch=whisper-base-smoke generated 4 tokens" in capsys.readouterr().out
