// K2b's bfloat16 form: sasrec_encoder_bwd.cu built with ACF_ENCODER_BF16 (the
// header's compute dtypes), replacing `bwd_kernel` of
// acf_tpu/ops/sasrec_fused.py:236 with cd = bfloat16: the vjp of the
// bfloat16 form of K2a. A unit of its own, so that nvcc builds it beside the
// float32 form; its C entries carry the suffix _bf16.
#define ACF_ENCODER_BF16 1
#include "sasrec_encoder_bwd.cu"
