"""The model FLOPs of each encoder, one module per ``transnet.arch``
(``roofline.counts``)."""
