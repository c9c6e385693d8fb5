"""Constants and host-table helpers shared by the port's modules."""
