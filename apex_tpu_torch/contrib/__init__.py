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
  and the optimizer wrapper that keeps pruned entries at 0;
* ``contrib.conv_bias_relu`` — Conv + Bias (+ Mask) + ReLU on NHWC
  activations, with XLA's "SAME" padding;
* ``contrib.bottleneck`` — the ResNet bottleneck block on the batch-norm
  kernel;
* ``contrib.groupbn`` — ``BatchNorm2d_NHWC`` at ``bn_group=1``.

The reference's ``optimizers`` (ZeRO) and the parts that need a process
group (``SpatialBottleneck``, ``halo_exchange``, ``spatial_conv3x3``,
``bn_group > 1``, ``split_data_axis_for_bn``) come with the multi-GPU
surface (ROADMAP queue 1, item 6).
"""
