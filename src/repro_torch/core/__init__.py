"""D-com core: runtime activation decomposition (counterpart of
``repro.core``; the reference's public names that the port has).

* ``LowRank`` — factored activation (+ outlier track);
* ``decompose`` — batched Lanczos truncated SVD of activations, and the
  scalar ``lanczos_svd`` (Fig. 2);
* ``lowrank_matmul`` … — decomposition-preserved linear algebra (§3.2);
* ``extract`` / ``ThresholdTable`` — channel-wise outliers (§4);
* ``DecompositionPolicy`` — per-layer configuration (§6.2);
* ``svd_alt`` — Fig. 2's other SVD contenders.

The reference's scalar ``LanczosHooks``, ``DEFAULT_HOOKS``,
``DEFAULT_BATCHED_HOOKS`` and ``batch_hooks`` have no counterpart: the
port's hooks are batched only and come from ``kernels.ops``.
"""
from .lowrank import (LowRank, from_dense_svd, gather_channels, rank_concat,
                      relative_error, retruncate, zero_channels)
from .lanczos import (BatchedLanczosHooks, BidiagResult, bidiag_to_svd,
                      bidiag_to_svd_batched, decompose, lanczos_bidiag,
                      lanczos_bidiag_batched, lanczos_svd)
from .outlier import (ThresholdTable, attach_dense_outliers,
                      calibrate_threshold, channel_outlier_counts, extract,
                      measured_extraction_frac, select_outlier_channels,
                      split_outliers)
from .preserved import (activation_compression_ratio, chain_flops,
                        compute_reduction_ratio_input_only,
                        compute_reduction_ratio_input_weight,
                        decompose_weight, lowrank_matmul,
                        lowrank_x_lowrank_weight, matmul_flops, plan_chain,
                        preserved_pv, preserved_qk_scores,
                        preserved_residual_add, weight_compression_ratio,
                        weight_rank_break_even)
from .policy import (PAPER_BEST_CONFIG, PAPER_LAYER_CONFIGS,
                     DecompositionPolicy, LayerPolicy)
from . import svd_alt

__all__ = [k for k in dir() if not k.startswith("_")]
