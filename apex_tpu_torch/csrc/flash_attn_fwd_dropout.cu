// The dropout instances of flash_attn_fwd.cu's wgmma forward (kDrop = true;
// the bucketed bias or none), in a translation unit of their own: the
// build compiles them beside the dropout-free ones, one nvcc process each,
// and the dropout-free kernels stay the code they were. The body, its
// design and its bound are flash_attn_fwd.cu's; the entries live there and
// reach these instances through apex::flash_fwd_dropout::run.
#define APEX_FLASH_DROPOUT_TU
#include "flash_attn_fwd.cu"
