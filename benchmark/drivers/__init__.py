"""One module per driver kind, named by a traffic file's ``driver`` key;
each has ``run(cell) -> harness.common.Outcome``."""
