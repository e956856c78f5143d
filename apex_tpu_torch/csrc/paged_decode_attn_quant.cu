// The int8 and fp8 e4m3 pools' instances of paged_decode_attn.cu's decode
// body (bf16 q, paged), in a translation unit of their own: the build
// compiles them beside the float instances, one nvcc process each, and
// the float kernels stay the code they were. The body, its design and its
// bound are paged_decode_attn.cu's; the entries live there and reach these
// instances through apex::decode_quant.
#define APEX_DECODE_QUANT_TU
#include "paged_decode_attn.cu"
