"""Torch copies of the repo's examples (``examples/``) for the port, run as
``python -m repro_torch.examples.<name>``; each takes ``--device`` (default:
the card)."""
import argparse


def device_args(doc: str, argv=None) -> argparse.Namespace:
    """The examples' command line: ``--device`` (default None, the card;
    ``cpu`` runs the plain versions)."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)
