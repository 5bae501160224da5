"""Models of the port: the Factorization Machine (``models.recsys.fm``)."""
