"""The harness: cells found by name, seeded inputs, the serving and
training parts every driver module shares, the trace, the comparison and
the result."""
