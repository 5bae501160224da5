"""Models of the port: the Factorization Machine (``models.recsys.fm``),
the transformer family (``models.transformer``) and the GNN family
(``models.gnn``)."""
