"""The plain references compute the published models: at a tiny size in
float64, each reference's logits against those of the ``transformers``
implementation of its architecture (``Qwen3ForCausalLM``,
``MambaForCausalLM``, ``OlmoeForCausalLM``, ``FalconMambaForCausalLM``),
on the same weights and tuples.  ``transformers`` normalises in float32,
so the two agree to float32's rounding."""
import os

import pytest
import torch

from bench import weights as W
from bench.harness import reference_module
from bench.tiny import tiny_cell

CASES = {"qwen3-8b.dsms-256x256": "Qwen3",
         "mamba-2.8b.dsms-512": "Mamba",
         "olmoe-1b-7b.dsms-256x1024": "Olmoe",
         "falcon-mamba-7b.dsms-512": "FalconMamba"}


def _rotate_half_order(dh: int) -> torch.Tensor:
    """The head columns of a checkpoint (pairs (i, i + dh/2)) in the
    harness's layout (pairs (2i, 2i + 1))."""
    return torch.cat([torch.arange(0, dh, 2), torch.arange(1, dh, 2)])


def _hf_model(arch: str, pub: dict, w: dict):
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    tf = pytest.importorskip("transformers")
    keys = {k: v for k, v in pub.items()
            if k not in ("architectures", "torch_dtype")}
    conf = getattr(tf, f"{arch}Config")(**keys)
    if arch in ("Mamba", "FalconMamba"):
        conf.residual_in_fp32 = False      # f64 throughout, as compared
    conf._attn_implementation = "eager"
    model = getattr(tf, f"{arch}ForCausalLM")(conf).to(torch.float64)
    model.eval()
    sd = {"lm_head.weight": W.head(w)}
    b = w["blocks"]
    if arch in ("Mamba", "FalconMamba"):
        sd["backbone.embeddings.weight"] = w["embed"]
        sd["backbone.norm_f.weight"] = w["final_norm"]
        for l in range(pub["num_hidden_layers"]):
            pre = f"backbone.layers.{l}."
            sd[pre + "norm.weight"] = b["norm"][l]
            m = pre + "mixer."
            sd[m + "in_proj.weight"] = b["w_in"][l].T
            sd[m + "conv1d.weight"] = b["conv_w"][l].T[:, None, :]
            sd[m + "conv1d.bias"] = b["conv_b"][l]
            sd[m + "x_proj.weight"] = b["w_x"][l].T
            sd[m + "dt_proj.weight"] = b["w_dt"][l].T
            sd[m + "dt_proj.bias"] = b["dt_bias"][l]
            sd[m + "A_log"] = b["A_log"][l]
            sd[m + "D"] = b["D_skip"][l]
            sd[m + "out_proj.weight"] = b["w_out"][l].T
    else:
        sd["model.embed_tokens.weight"] = w["embed"]
        sd["model.norm.weight"] = w["final_norm"]
        a = b["attn"]
        D = pub["hidden_size"]
        for l in range(pub["num_hidden_layers"]):
            pre = f"model.layers.{l}."
            sd[pre + "input_layernorm.weight"] = b["norm1"][l]
            sd[pre + "post_attention_layernorm.weight"] = b["norm2"][l]
            order = _rotate_half_order(a["wq"].shape[-1])
            for n in ("q", "k"):
                t = a[f"w{n}"][l][:, :, order]
                sd[pre + f"self_attn.{n}_proj.weight"] = t.reshape(D, -1).T
            sd[pre + "self_attn.v_proj.weight"] = a["wv"][l].reshape(D, -1).T
            sd[pre + "self_attn.o_proj.weight"] = a["wo"][l].T
            if "q_norm" in a:
                sd[pre + "self_attn.q_norm.weight"] = a["q_norm"][l][order]
                sd[pre + "self_attn.k_norm.weight"] = a["k_norm"][l][order]
            if "mlp" in b:
                for n in ("gate", "up", "down"):
                    sd[pre + f"mlp.{n}_proj.weight"] = b["mlp"][f"w_{n}"][l].T
            else:
                moe = b["moe"]
                sd[pre + "mlp.gate.weight"] = moe["w_router"][l].T
                for e in range(pub["num_experts"]):
                    for n in ("gate", "up", "down"):
                        sd[pre + f"mlp.experts.{e}.{n}_proj.weight"] = \
                            moe[f"w_{n}"][l, e].T
    for k, v in model.state_dict().items():
        if k not in sd:
            sd[k] = v                      # full-width q/k norms: ones
    model.load_state_dict(sd, strict=True)
    return model


@pytest.mark.parametrize("workload", sorted(CASES))
def test_reference_is_the_published_model(workload):
    cell = tiny_cell(workload)
    m, pub = cell.config["model"], cell.config["published"]
    w = W.make(m, 11, torch.device("cpu"))
    model = _hf_model(CASES[workload], pub, w)
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, m["vocab"], (3, 7), generator=g)
    ref = reference_module(cell.config["reference"])
    with torch.no_grad():
        want = model(tokens).logits
        h, _ = ref.hidden(w, pub, tokens, torch.arange(3),
                          dtype=torch.float64)
        got = h @ W.head(w).T
    err = (got - want).abs().max().item()
    assert err < 1e-4 * want.abs().max().item(), err
