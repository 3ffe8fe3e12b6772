"""Logical-axis sharding rules of the port (`sharding.rules`)."""
