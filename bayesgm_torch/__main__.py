"""``python -m bayesgm_torch`` runs the port's CLI."""

from bayesgm_torch.cli.cli import main

if __name__ == "__main__":
    main()
