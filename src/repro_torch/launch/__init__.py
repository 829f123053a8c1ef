"""Entry points of the language models (serving only, for now)."""
