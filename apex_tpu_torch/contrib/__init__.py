"""Optional extensions: the port of ``apex_tpu/contrib`` (``apex.contrib``).

The submodules the port has, each imported on demand as in the reference:

* ``contrib.multihead_attn`` — self and encoder-decoder MHA modules on the
  flash kernels;
* ``contrib.fmha`` — the fused MHA core over packed variable-length rows;
* ``contrib.xentropy`` — the fused softmax cross-entropy;
* ``contrib.focal_loss`` — the fused sigmoid focal loss.

The reference's other submodules (``layer_norm``, ``optimizers``,
``transducer``, ``sparsity``, ``groupbn``, ``bottleneck``,
``conv_bias_relu``) are later slices (ROADMAP queue 1, item 9).
"""
