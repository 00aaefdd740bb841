"""Sharding rules and their DTensor placements."""
