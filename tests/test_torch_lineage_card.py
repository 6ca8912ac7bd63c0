"""The modules off the main path on a card (`gpu`; each test skips itself
without one). This file imports no JAX, so that `pytest --noconftest -m gpu
tests/test_torch_lineage_card.py` runs on a machine without it.

`BertTextModel` in fp32 (hidden 128 in 2 heads of 64, the head width the
kernel takes; 2 layers; padded masks) through kernel 1 against the same
model with the plain attention: the kernel's fp32 gate is 1e-5 a call, and
the two layers add their differences, so sequence and pooled outputs are
held to 2 x 1e-5; `embed_vocab` launches the kernel once per layer and
chunk. Then every research-lineage module of `chip_smoke.lineage_cases`
at small widths, forward and backward on the card against a float64
reference on the CPU (`chip_smoke.lineage_on_device`, gated by
`lineage_failures`).
"""
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from xggm_tpu_torch.config import BertConfig
from xggm_tpu_torch.data.tokenizer import BertTokenizer, make_test_vocab
from xggm_tpu_torch.models.lxmert import BertTextModel
from xggm_tpu_torch.ops import attention as attn
from xggm_tpu_torch.ops.basic import init_weights
from xggm_tpu_torch.tools.compute_adjacency import (
    adjacency_from_ids, embed_vocab)

LAYERS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_bert_text_model_kernel_1_against_plain(cuda):
    vocab = make_test_vocab()
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=128,
                     num_attention_heads=2, intermediate_size=256)
    model = init_weights(BertTextModel(cfg, LAYERS, device=cuda),
                         torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, len(vocab), (8, 16))).to(cuda)
    mask = (torch.arange(16)[None] < torch.arange(2, 18, 2)[:, None]).long()
    mask = mask.to(cuda)
    with torch.no_grad():
        attn.fused_attention.launches = 0
        got = model(ids, mask)
        assert attn.fused_attention.launches == LAYERS
        with mock.patch.object(attn, "fused_attention",
                               attn.attention_reference):
            want = model(ids, mask)
    for g, w in zip(got, want):
        assert g.is_cuda and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= LAYERS * 1e-5

    tok = BertTokenizer(vocab)
    names = ["dog", "cat on the left", "run", "a color", "what is"]
    attn.fused_attention.launches = 0
    emb = embed_vocab(names, tok, model, max_len=16, batch_size=2)
    assert attn.fused_attention.launches == 3 * LAYERS  # 3 chunks of 2
    assert emb.shape == (5, 128)
    adj = adjacency_from_ids(torch.zeros(36, dtype=torch.long, device=cuda),
                             torch.arange(36, device=cuda) % 5,
                             torch.from_numpy(emb).to(cuda),
                             torch.from_numpy(emb).to(cuda))
    assert adj.is_cuda and float(adj.max()) == pytest.approx(1.0)


@pytest.mark.gpu
def test_lineage_modules_on_the_card_match_the_cpu(cuda):
    widths = dict(b=6, n=36, f=32, answers=40, vae_hidden=16, mi_hidden=16,
                  mixin_hidden=24, v_dim=48, num_hid=32, emb=12, ntoken=50,
                  seq=7)
    rows = chip_smoke.lineage_on_device(torch, widths)
    assert len(rows) == len(chip_smoke.lineage_cases(torch, widths))
    assert chip_smoke.lineage_failures(rows) == []
