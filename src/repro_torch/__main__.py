"""``python -m repro_torch`` — run a declarative pipeline config file."""
from repro_torch.api.cli import main

if __name__ == "__main__":
    main()
