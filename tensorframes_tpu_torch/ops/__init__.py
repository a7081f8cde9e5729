"""The port's execution layer: the serial executor and verb validation."""
