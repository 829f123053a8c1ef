"""Step functions of the language models (serving only, for now)."""
