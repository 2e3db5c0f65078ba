"""The plain reference against the port at its SMOKE sizes on the CPU: the
weights drawn again from a variant's name are the served ones bit for bit,
and the reference's logits match the port's prefill and its decode steps
through the cache."""

from __future__ import annotations

import pytest
import torch

from bench import check, ladder
from bench.reference import weights as RW
from bench.tests.smoke import SMOKE

CASES = [("qwen2.5-3b", "qwen2", "full", False),
         ("qwen2.5-3b", "qwen2", "w050", False),
         ("qwen2.5-3b", "qwen2", "w050", True),
         ("rwkv6-3b", "rwkv6", "full", False),
         ("rwkv6-3b", "rwkv6", "w025", False)]


def smoke_model(name):
    from bench.harness import read_json, BENCH
    c = read_json(BENCH / "configs" / f"{name}.json")
    c["model"].update(SMOKE[name], param_dtype="float32",
                      activation_dtype="float32")
    return c


def port_rung(c, tag, app):
    from repro_torch.core.variants import build_ladder
    from bench.harness import model_config
    cfg = model_config(c).replace(name=f"{c['name']}.{app}")
    return next(v for v in build_ladder(cfg) if v.name.endswith(":" + tag))


PAIRS_ATTN = {"wq": ("attn", "wq"), "wk": ("attn", "wk"),
              "wv": ("attn", "wv"), "wo": ("attn", "wo"),
              "w_gate": ("ffn", "w_gate"), "w_up": ("ffn", "w_up"),
              "w_down": ("ffn", "w_down"), "bq": ("attn", "bq"),
              "bk": ("attn", "bk"), "bv": ("attn", "bv")}
PAIRS_RWKV = {"tm_mix": ("tm", "mix"), "tm_w_r": ("tm", "w_r"),
              "tm_w_k": ("tm", "w_k"), "tm_w_v": ("tm", "w_v"),
              "tm_w_g": ("tm", "w_g"), "tm_w_o": ("tm", "w_o"),
              "decay_w1": ("tm", "decay_w1"), "decay_w2": ("tm", "decay_w2"),
              "decay_base": ("tm", "decay_base"),
              "bonus_u": ("tm", "bonus_u"), "cm_mix": ("cm", "mix"),
              "cm_w_in": ("cm", "w_in"), "cm_w_out": ("cm", "w_out"),
              "cm_w_r": ("cm", "w_r")}


@pytest.mark.parametrize("name,family,tag,biased", CASES)
def test_reference_matches_the_port_prefill_then_decode(name, family, tag,
                                                        biased):
    from repro_torch.models import model as MDL
    from repro_torch.serving.server import draw_params

    c = smoke_model(name)
    variant = port_rung(c, tag, "app1")
    params = draw_params(variant, torch.device("cpu"))
    dims = ladder.rung_dims(c["model"], tag)
    w = RW.draw_weights(dims, variant.name, torch.device("cpu"))
    # the draws: the port's tree, bit for bit
    stack = params["cycles"][0]
    names = (PAIRS_ATTN if family == "qwen2" else PAIRS_RWKV)
    for c, layer in enumerate(w["layers"]):
        assert set(layer) == set(names) - (
            set() if c_qkv_bias(dims) else {"bq", "bk", "bv"})
        for ours in layer:
            group, key = names[ours]
            assert torch.equal(layer[ours], stack[group][key][c]), (c, ours)
    if biased:
        # the bias is drawn as zero: give both sides the same nonzero one
        gb = torch.Generator().manual_seed(11)
        for c, layer in enumerate(w["layers"]):
            for key in ("bq", "bk", "bv"):
                b = torch.randn(layer[key].shape, generator=gb)
                layer[key] = b.to(layer[key].dtype)
                with torch.inference_mode():
                    stack["attn"][key][c] = b.to(stack["attn"][key].dtype)
    assert torch.equal(w["embed"], params["embed"]["table"])
    assert torch.equal(w["unembed"], MDL.unembed_table(params)["table"])

    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, dims["vocab_size"], (1, 37), generator=g)
    cache = MDL.init_cache(variant.config, 1, 48, device="cpu")
    with torch.inference_mode():
        logits, cache = MDL.prefill(params, variant.config, prompt, cache)
        got = [logits[0]]
        tok = int(logits[0].argmax())
        toks = [tok]
        for _ in range(5):
            logits, cache = MDL.decode_step(
                params, variant.config, torch.tensor([tok], dtype=torch.int32),
                cache)
            got.append(logits[0])
            tok = int(logits[0].argmax())
            toks.append(tok)
    ref = check.reference_module(family)
    seq = torch.cat([prompt[0], torch.tensor(toks[:-1])])
    want = ref.forward(w, dims, seq, len(toks))
    got = torch.stack(got).float()
    assert torch.allclose(got, want, atol=2e-4, rtol=0), \
        float((got - want).abs().max())
    # the check itself reads no gap on the port's greedy tokens
    best = want.max(-1).values
    gap = best - want.gather(1, torch.tensor(toks)[:, None])[:, 0]
    assert float(gap.max()) <= 2e-4


def c_qkv_bias(dims):
    return bool(dims.get("qkv_bias"))


def test_control_rounds_to_fp8():
    from bench.reference import quant
    x = torch.randn(16, 64)
    q = quant.fp8(x, -1)
    rel = ((q - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 0 < float(rel) < 2 ** -4
    assert torch.equal(quant.linear(x, torch.eye(64), False), x)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path
    ref_dir = Path(check.__file__).parent / "reference"
    for path in ref_dir.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "math",
                                           "zlib", "typing",
                                           "__future__"}, \
                    (path.name, n)
