"""The model FLOPs of each prediction network, one module per
``prednet.rnn_type`` (``roofline.counts``)."""
