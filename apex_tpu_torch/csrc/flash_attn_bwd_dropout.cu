// The dropout instances of flash_attn_bwd.cu's wgmma dQ and dK/dV kernels
// (kDrop = true; the bucketed bias, the array bias or none), in a
// translation unit of their own: the build compiles them beside the
// dropout-free ones, one nvcc process each, and the dropout-free kernels
// stay the code they were. The bodies, their design and their bounds are
// flash_attn_bwd.cu's; the entries live there and reach these instances
// through apex::flash_bwd_dropout::run.
#define APEX_FLASH_DROPOUT_TU
#include "flash_attn_bwd.cu"
