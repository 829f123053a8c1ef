"""Models of the port: the paper CNN (``cnn``) and the dense decoders of
the language-model zoo (``layers``, ``blocks``, ``lm``)."""
