"""Entry: python -m whisper_apr_tpu_torch.cli <command> ...

(reference: src/bin/whisper-apr-cli.rs:17 — thin shell: parse + dispatch)
"""

from . import main

if __name__ == "__main__":
    main()
