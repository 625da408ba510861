"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (ratio 3:1 mLSTM:sLSTM), d_ff=0
(projections live inside the cells). [arXiv:2405.04517; unverified]
"""

from repro_torch.configs.base import ARCHS, MLSTM, SLSTM, ModelConfig, SSMConfig


@ARCHS.register("xlstm-125m")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,                      # per assigned config: blocks are self-contained
        vocab=50304,
        block_pattern=(MLSTM, MLSTM, MLSTM, SLSTM),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
        source="arXiv:2405.04517; unverified",
    )
