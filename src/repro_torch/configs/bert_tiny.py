"""bert-tiny (Turc et al. 2019), the paper's Table 1 model: 2 layers,
d=128, 2 heads of 64, d_ff=512, WordPiece vocab 30522, post-LN, GELU
with biases, float32."""
from .base import ArchConfig
from .registry import register

CONFIG = register(ArchConfig(
    name="bert-tiny", family="encoder",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=512, vocab=30522,
    rope_variant="none", norm_type="layer", ffn_type="gelu", bias=True,
    param_dtype="float32",
    source="arXiv:1908.08962",
))
