"""The general parts of the harness: cell lookup, the result line, spans,
the traffic generator, weights from the seed, the trace reduction."""
