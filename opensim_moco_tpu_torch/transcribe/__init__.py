"""Direct-collocation transcription (see transcription.py)."""
