"""Model configurations of the port (the paper CNN only, for now)."""
