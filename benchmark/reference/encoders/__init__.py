"""One module per encoder, named by ``transnet.arch`` (``reference.parts``)."""
