"""The architecture code holds the numbers it gave before it moved into
``arch/gqa.py``. The values below were recorded on commit 92f43e0, where
the GQA model still lived in ``bench.py``, ``weights.py``,
``reference.py`` and ``roofline.py``, and are compared bit for bit: the
weights of ``make_params`` at the CPU tests' widths (float32 on the CPU)
and at full width (bf16 on the card), the reference logits of a 96-token
stream in float32 and in the fp8 control, and the roofline counts at the
published widths.

A weight's or a logit tensor's checksum is the pair (sum, sum weighted by
the flat position mod 7 plus 1) in float64: exact (``math.fsum``) on the
CPU, in fixed chunks on the card.
"""
import json
import math
import os

import pytest
import torch

from mars_bench import arch, reference, roofline, weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["qwen3-coder-30b-a3b", "internlm2-20b"]
TOY_SEED = 271828182845
CARD_SEED = 314159265358
T = 96
KEYS = (1, 977, 14000)
PACKS = ((0, 2048), (12000, 1926), (5, 32))
LANES = ((1,), (513, 2, 14000), tuple(range(100, 1700, 100)))


def load(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{path}{k}.")
        else:
            yield f"{path}{k}", tree[k]


def exact_sums(t):
    x = t.detach().to("cpu", torch.float64).flatten()
    w = torch.arange(x.numel(), dtype=torch.float64) % 7 + 1
    return math.fsum(x.tolist()), math.fsum((x * w).tolist())


def card_sums(t):
    flat = t.reshape(-1)
    s = w = 0.0
    step = 1 << 26
    for i in range(0, flat.numel(), step):
        c = flat[i:i + step].double()
        wt = torch.arange(i, i + c.numel(), device=t.device,
                          dtype=torch.float64) % 7 + 1
        s += c.sum().item()
        w += (c * wt).sum().item()
    return s, w


def counts(cfg):
    return {
        "active_params": roofline.active_params(cfg),
        "kv_bytes_per_token_layer": roofline.kv_bytes_per_token_layer(cfg),
        "attn_flops": [roofline.attn_flops(cfg, k) for k in KEYS],
        "token_flops": [roofline.token_flops(cfg, k, lg) for k in KEYS
                        for lg in (False, True)],
        "pack_flops": [roofline.pack_flops(cfg, s, n) for s, n in PACKS],
        "decode_attn_work": [list(roofline.decode_attn_work(cfg, ls))
                             for ls in LANES],
        "prefill_attn_work": [list(roofline.prefill_attn_work(cfg, s, n))
                              for s, n in PACKS],
    }


PINS = {
    "qwen3-coder-30b-a3b": {
        "weights": {
            "embed": (-5.302682580095734, -51.27386929631257),
            "layers.attn.wk": (6.669678448899504, 33.00800678152518),
            "layers.attn.wo": (0.3074311999193924, -21.27614823389149),
            "layers.attn.wq": (-5.383496702850607, -16.79192700195381),
            "layers.attn.wv": (-1.9658616403467022, 9.975050547349383),
            "layers.ln_attn.scale": (0.0, 0.0),
            "layers.ln_mlp.scale": (0.0, 0.0),
            "layers.moe.router": (-1.7027949504190474, -10.279024583447608),
            "layers.moe.w_down": (2.437990642405566, -44.427301840345535),
            "layers.moe.w_gate": (19.131748378938028, 79.32403667058861),
            "layers.moe.w_up": (18.9849867190203, 79.13258369322034),
            "lm_head": (41.360309958801736, 143.45755473548525),
            "ln_final.scale": (0.0, 0.0),
        },
        "logits": {
            "f32": (-1646.0558766287995, -6538.42132954191),
            "fp8": (-1425.974346946714, -5783.253048163555),
        },
        "counts": {
            "active_params": 2730491904,
            "kv_bytes_per_token_layer": 2048,
            "attn_flops": [786432.0, 768344064.0, 11010048000.0],
            "token_flops": [
                5461770240.0,
                6084100096.0,
                6229327872.0,
                6851657728.0,
                16471031808.0,
                17093361664.0,
            ],
            "pack_flops": [12834789916672.0, 30153876176896.0, 175914876928.0],
            "decode_attn_work": [
                [16384.0, 18432],
                [237813760.0, 29775872],
                [222822400.0, 28114944],
            ],
            "prefill_attn_work": [
                [34376515584.0, 37748736],
                [409070813184.0, 60076032],
                [11272192.0, 600064],
            ],
        },
    },
    "internlm2-20b": {
        "weights": {
            "embed": (9.659276250602261, 69.28615162029291),
            "layers.attn.wk": (6.669678448899504, 33.00800678152518),
            "layers.attn.wo": (0.3074311999193924, -21.27614823389149),
            "layers.attn.wq": (-5.383496702850607, -16.79192700195381),
            "layers.attn.wv": (-1.9658616403467022, 9.975050547349383),
            "layers.ln_attn.scale": (0.0, 0.0),
            "layers.ln_mlp.scale": (0.0, 0.0),
            "layers.mlp.w_down": (21.265645448614123, 84.81813654743928),
            "layers.mlp.w_gate": (2.948188225828744, 17.551152656185877),
            "layers.mlp.w_up": (4.623168014722978, 24.42825277994234),
            "lm_head": (-2.5008442697671853, -51.29299257160346),
            "ln_final.scale": (0.0, 0.0),
        },
        "logits": {
            "f32": (-51.864493788678374, -389.9434070831485),
            "fp8": (5.07859424653725, -96.19145981222391),
        },
        "counts": {
            "active_params": 18723373056,
            "kv_bytes_per_token_layer": 4096,
            "attn_flops": [1179648.0, 1152516096.0, 16515072000.0],
            "token_flops": [
                37447925760.0,
                38585106432.0,
                38599262208.0,
                39736442880.0,
                53961818112.0,
                55098998784.0,
            ],
            "pack_flops": [
                79167182340096.0,
                101576668741632.0,
                1200244654080.0,
            ],
            "decode_attn_work": [
                [24576.0, 28672],
                [356720640.0, 59527168],
                [334233600.0, 56098816],
            ],
            "prefill_attn_work": [
                [51564773376.0, 58720256],
                [613606219776.0, 104374272],
                [16908288.0, 937984],
            ],
        },
    },
}

CARD = {  # NVIDIA H100 80GB HBM3, torch 2.11.0+cu128
    "qwen3-coder-30b-a3b": {
        "embed": (88.0728776922333, 335.15781853892986),
        "layers.attn.wk": (202.95262747702873, 614.3843000466186),
        "layers.attn.wo": (-35.99879900461701, -488.3759285698975),
        "layers.attn.wq": (-130.3288062149877, 419.73608323875305),
        "layers.attn.wv": (91.87383083044551, 990.7045240740117),
        "layers.ln_attn.scale": (0.0, 0.0),
        "layers.ln_mlp.scale": (0.0, 0.0),
        "layers.moe.router": (39.85510624237941, 245.59938237196184),
        "layers.moe.w_down": (5027.321977337293, 12722.765644369038),
        "layers.moe.w_gate": (619.3146556664533, 7162.659821347647),
        "layers.moe.w_up": (-13.335418154899344, 2852.5181797314835),
        "lm_head": (-964.0229776440829, -4079.364037395484),
        "ln_final.scale": (0.0, 0.0),
    },
    "internlm2-20b": {
        "embed": (-701.7265937767611, -2613.0533327824573),
        "layers.attn.wk": (-11.20044974178927, -809.1479717708316),
        "layers.attn.wo": (-279.9362903086658, -1932.9852078970653),
        "layers.attn.wq": (-59.45821918065758, -667.7876773681164),
        "layers.attn.wv": (171.9774403892916, 204.91701166823987),
        "layers.ln_attn.scale": (0.0, 0.0),
        "layers.ln_mlp.scale": (0.0, 0.0),
        "layers.mlp.w_down": (811.663615284851, 3185.4864092695357),
        "layers.mlp.w_gate": (-522.9346231937261, -650.11863112022),
        "layers.mlp.w_up": (-144.0514150535755, -1154.9839256355936),
        "lm_head": (157.57555153419707, 941.8934490846004),
        "ln_final.scale": (0.0, 0.0),
    },
}


@pytest.mark.parametrize("name", NAMES)
def test_toy_weights_hold(name, one_thread):
    cfg = load(name)
    toy = arch.module(cfg).toy(cfg)
    params = weights.make_params(toy, TOY_SEED, dtype=torch.float32,
                                 device="cpu")
    got = {k: exact_sums(v) for k, v in leaves(params)}
    assert got == PINS[name]["weights"]


@pytest.mark.parametrize("precision", ["f32", "fp8"])
@pytest.mark.parametrize("name", NAMES)
def test_reference_logits_hold(name, precision, one_thread):
    cfg = load(name)
    toy = arch.module(cfg).toy(cfg)
    params = weights.make_params(toy, TOY_SEED, dtype=torch.float32,
                                 device="cpu")
    toks = torch.randint(0, toy["vocab_size"], (T,),
                         generator=torch.Generator().manual_seed(3))
    logits = reference.forward_logits(toy, params, toks.tolist(),
                                      list(range(T)), moe_groups=[(0, T, T)],
                                      precision=precision)
    assert exact_sums(logits) == PINS[name]["logits"][precision]


@pytest.mark.parametrize("name", NAMES)
def test_roofline_counts_hold(name):
    assert counts(load(name)) == PINS[name]["counts"]


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_card_weights_hold(name, card):
    params = weights.make_params(load(name), CARD_SEED,
                                 dtype=torch.bfloat16, device=card)
    got = {k: card_sums(v) for k, v in leaves(params)}
    assert got == CARD[name]


def test_a_configuration_without_arch_is_gqa():
    for name in NAMES:
        cfg = load(name)
        assert "arch" not in cfg
        assert arch.module(cfg) is arch.module(dict(cfg, arch="gqa"))
        assert arch.module(cfg).__file__ == os.path.join(HERE, "arch",
                                                         "gqa.py")
