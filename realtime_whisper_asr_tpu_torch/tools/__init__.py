"""Tools of the port: checkpoint conversion, and measurements that run on
the card (importing them runs nothing)."""
