"""Launchers: the party host of a two-process deployment, the MPC meshes
over ``torch.distributed`` and the MPC serving step."""
