// The fp16 instances of flash_attn_bwd.cu's wgmma dQ and dK/dV kernels (T =
// __half; the entries apex_flash_bwd_dq_f16 and apex_flash_bwd_dkv_f16 on
// the packed buffer's views, without kv_lens, bias or dropout), in a
// translation unit of their own: the build compiles them beside the bf16
// instances, one nvcc process each, and those stay the code they were. The
// bodies, their design and their bounds are flash_attn_bwd.cu's.
#define APEX_FLASH_F16_TU
#include "flash_attn_bwd.cu"
