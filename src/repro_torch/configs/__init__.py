"""Configurations of the port: the recsys shapes and the FM cell builder."""
