"""Anchors, box coding, overlaps and NMS of the port."""
