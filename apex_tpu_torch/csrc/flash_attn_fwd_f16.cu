// The fp16 instance of flash_attn_fwd.cu's wgmma forward (T = __half; the
// packed entry apex_flash_fwd_f16, without kv_lens, bias or dropout), in a
// translation unit of its own: the build compiles it beside the bf16
// instances, one nvcc process each, and they stay the code they were. The
// body, its design and its bound are flash_attn_fwd.cu's.
#define APEX_FLASH_F16_TU
#include "flash_attn_fwd.cu"
