"""The port's int8 weight-only storage (``utils/quant.py``) against the JAX
package's on the CPU.

- ``quantize``/``dequantize`` of a torch Linear weight (out, in) equal JAX's
  on the same weight as a flax kernel (in, out): the same int8 values, the
  same scales, the same dequantized weight, exactly in float32 (the same
  operations: max, divide, round half to even, clip, multiply);
- ``QuantizedLinear`` computes ``F.linear`` with that weight;
- the default scope (``default_should_quantize``) picks the same matmul
  weights as JAX's ``_default_should_quantize`` on a decoder whose weights
  straddle the 16,384-value threshold, and ``module_nbytes`` of the
  quantized model equals JAX's ``tree_nbytes``.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from upscale_a_video_tpu.models.llava.llama import LlamaConfig as JLlamaConfig
from upscale_a_video_tpu.models.llava.llama import LlamaForCausalLM as JLlama
from upscale_a_video_tpu.models.llava.llama import causal_prefill_mask as j_prefill_mask
from upscale_a_video_tpu.utils.quant import QuantizedTensor, dequantize as j_dequantize
from upscale_a_video_tpu.utils.quant import quantize as j_quantize
from upscale_a_video_tpu.utils.quant import quantize_tree, tree_nbytes
from upscale_a_video_tpu_torch.models.llava.convert import LLAVA_RENAMES
from upscale_a_video_tpu_torch.models.llava.llama import LlamaConfig, LlamaForCausalLM
from upscale_a_video_tpu_torch.utils.quant import (QuantizedLinear, dequantize, module_nbytes,
                                                   quantize, quantize_module_)
from upscale_a_video_tpu_torch.weights import flatten_tree, to_state_dict

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(64, 48), (7, 300), (256, 64)])
def test_quantize_and_dequantize_match_jax_exactly(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, (shape[0], 1))).astype(np.float32)
    w[0] = 0.0  # an all-zero channel takes the 1e-12 floor
    q, scale = quantize(torch.from_numpy(w))
    jq = j_quantize(w.T, axis=-1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq.values).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jq.scale).T)
    np.testing.assert_array_equal(dequantize(q, scale).numpy(), np.asarray(j_dequantize(jq)).T)
    assert q.dtype == torch.int8 and scale.shape == (shape[0], 1)

    lin = torch.nn.Linear(shape[1], shape[0])
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
    ql = QuantizedLinear(lin)
    x = torch.from_numpy(rng.standard_normal((5, shape[1])).astype(np.float32))
    want = F.linear(x, torch.from_numpy(np.asarray(j_dequantize(jq)).T.copy()), lin.bias)
    assert torch.equal(ql(x), want)
    assert ql.weight.dtype == torch.int8 and ql.bias is lin.bias


def test_default_scope_and_bytes_match_jax():
    """Hidden 128, MLP 256, vocabulary 200: q/k/v/o (16,384 values each),
    the MLP and lm_head are quantized, the embedding and the norms are not,
    as JAX decides."""
    kw = dict(vocab_size=200, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4)
    jm = JLlama(JLlamaConfig(**kw))
    s = 4
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, s), np.int32), np.arange(s),
                     j_prefill_mask(s, s),
                     method=lambda m, ids, pos, mask: m(m.embed(ids), pos, None, 0, mask))["params"]
    jq = quantize_tree(params)
    n_jax = sum(isinstance(x, QuantizedTensor) for x in jax.tree_util.tree_leaves(
        jq, is_leaf=lambda x: isinstance(x, QuantizedTensor)))

    flat = {("language_model",) + k: np.asarray(v)
            for k, v in flatten_tree(jax.tree.map(np.asarray, params)).items()}
    tm = LlamaForCausalLM(LlamaConfig(**kw))
    tm.load_state_dict(to_state_dict(flat, LLAVA_RENAMES), strict=True)
    quantize_module_(tm)
    quantized = [n for n, m in tm.named_modules() if isinstance(m, QuantizedLinear)]
    assert len(quantized) == n_jax == 2 * 7 + 1  # every layer's 7 products and lm_head
    assert module_nbytes(tm) == tree_nbytes(jq)
    assert not isinstance(tm.model.embed_tokens, QuantizedLinear)
