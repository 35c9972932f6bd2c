"""Decodes over a mesh of devices (airjax/parallel): the halo-sharded
capture and stream decode (halo.py) and the multi-channel decode
(channels.py) over a 1-D `mesh.Mesh`, and the decode of a capture split
over the processes of a torch.distributed job (multihost.py)."""
