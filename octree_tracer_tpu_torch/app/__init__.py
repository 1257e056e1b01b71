"""The interactive session: the adaptive streaming loop."""
