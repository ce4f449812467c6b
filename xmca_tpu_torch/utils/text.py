"""Text helpers for file names, titles and the ``info.xmca`` layout.

The port's own copy of ``xmca_tpu/utils/text.py`` (the port imports
nothing of the JAX package).
"""
import textwrap


def secure_str(string):
    """Sanitize a string for use as a file name (lowercase, no spaces)."""
    return string.lower().replace(' ', '_')


def boldify_str(string):
    """Wrap a string in TeX bold if matplotlib uses usetex, else pass it
    through."""
    try:
        import matplotlib.pyplot as plt
        usetex = plt.rcParams['text.usetex']
    except Exception:
        usetex = False
    if usetex:
        return ''.join([r'\textbf{', string, '}'])
    return string


def wrap_str(string, width=80):
    """Fill text to `width` columns and prefix every line with '# '."""
    return textwrap.indent(textwrap.fill(string, width=width), '# ')
