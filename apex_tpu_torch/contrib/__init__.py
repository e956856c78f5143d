"""Optional extensions: the port of ``apex_tpu/contrib`` (``apex.contrib``).

The submodules the port has, each imported on demand as in the reference:

* ``contrib.multihead_attn`` — self and encoder-decoder MHA modules on the
  flash kernels;
* ``contrib.fmha`` — the fused MHA core over packed variable-length rows;
* ``contrib.xentropy`` — the fused softmax cross-entropy;
* ``contrib.focal_loss`` — the fused sigmoid focal loss;
* ``contrib.layer_norm`` — ``FastLayerNorm``, the norm kernels past hidden
  4096 (to 65536);
* ``contrib.transducer`` — the RNN-T joint and loss;
* ``contrib.sparsity`` — ASP: 2:4 masks, the channel-permutation search
  and the optimizer wrapper that keeps pruned entries at 0.

The reference's other submodules (``optimizers``, ``groupbn``,
``bottleneck``, ``conv_bias_relu``) are later slices (ROADMAP queue 1,
item 9).
"""
