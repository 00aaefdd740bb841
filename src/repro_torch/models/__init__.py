"""Model definitions served through the port."""
