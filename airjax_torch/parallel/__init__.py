"""Decodes over a mesh of devices (airjax/parallel): the halo-sharded
capture and stream decode (halo.py) and the multi-channel decode
(channels.py) over a 1-D `mesh.Mesh`."""
