"""The model FLOPs of each joint, one module per ``jointnet.combine``
(``roofline.counts``)."""
