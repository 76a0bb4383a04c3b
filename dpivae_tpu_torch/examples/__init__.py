"""Example programs of the port (counterparts of examples/)."""
