// K2a's bfloat16 form: sasrec_encoder_fwd.cu built with ACF_ENCODER_BF16 (the
// header's compute dtypes), replacing `fwd_kernel` of
// acf_tpu/ops/sasrec_fused.py:225 with cd = bfloat16. A unit of its own, so
// that nvcc builds it beside the float32 form; its C entry is
// acf_sasrec_encoder_fwd_bf16.
#define ACF_ENCODER_BF16 1
#include "sasrec_encoder_fwd.cu"
