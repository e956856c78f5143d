// The causal bucketed bias's instances of paged_decode_attn.cu's decode
// body (bf16, paged and contiguous), in a translation unit of their own:
// the build compiles them beside the float instances, one nvcc process
// each. The body, its design and its bound are paged_decode_attn.cu's; the
// entries live there and reach these instances through apex::decode_rel.
#define APEX_DECODE_REL_TU
#include "paged_decode_attn.cu"
