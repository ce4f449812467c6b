"""Explicit device resolution.

The port never picks a device by itself and never falls back: a model is
built for the device its caller names (``'cuda'`` by default), and asking
for CUDA on a machine without a card is an error, not a silent CPU run.
"""
import torch


def resolve_device(device='cuda'):
    """``torch.device`` for ``device``; raises when CUDA is asked for but
    absent, or for a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(
            'unsupported device type {!r}: use cuda or cpu'.format(dev.type)
        )
    return dev
