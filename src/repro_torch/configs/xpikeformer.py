"""The paper's spiking GPT decoders on the generic LM stack.

Copies of ``repro.configs.xpikeformer.xpikeformer_gpt`` and the two
registered decoders (Table IV: 4 layers x 256 wide and 8 x 512, head
width 64, ``d_ff = 4 d``, vocab 64, ``T = 4``, SSA attention).
"""

from repro_torch.configs.base import ModelConfig


def xpikeformer_gpt(depth: int, dim: int, *, vocab: int, T: int = 4,
                    spiking: bool = True, attention_kind: str = "ssa"
                    ) -> ModelConfig:
    return ModelConfig(
        name=f"xpikeformer-gpt-{depth}-{dim}",
        family="dense",
        num_layers=depth,
        d_model=dim,
        num_heads=max(dim // 64, 1),
        num_kv_heads=max(dim // 64, 1),
        head_dim=64,
        d_ff=4 * dim,
        vocab_size=vocab,
        norm_type="layernorm",
        act="gelu",
        gated_mlp=False,
        spiking=spiking,
        spike_T=T,
        attention_kind=attention_kind,
        rope_theta=10000.0,
        dtype="float32",
    ).validate()


GPT_4_256 = xpikeformer_gpt(4, 256, vocab=64)
GPT_8_512 = xpikeformer_gpt(8, 512, vocab=64)
