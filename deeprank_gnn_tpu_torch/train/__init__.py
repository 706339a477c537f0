"""The scoring engine, losses, metrics and checkpoint loading."""
