"""One module per joint, named by ``jointnet.combine`` (``reference.parts``)."""
