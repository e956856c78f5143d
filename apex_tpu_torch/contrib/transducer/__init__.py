"""RNN-T transducer joint and loss.

Port of ``apex_tpu/contrib/transducer`` (``apex.contrib.transducer``).
"""

from apex_tpu_torch.contrib.transducer.transducer import (  # noqa: F401
    TransducerJoint,
    TransducerLoss,
    transducer_joint,
    transducer_loss,
)
