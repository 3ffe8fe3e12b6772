"""Data of the port: the synthetic LM pipeline (`data.pipeline`)."""
