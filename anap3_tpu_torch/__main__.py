"""``python -m anap3_tpu_torch <overrides>``: the port's CLI (``main.py``)."""

from .main import main

if __name__ == "__main__":
    main()
