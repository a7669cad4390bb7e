from iterative_cleaner_tpu_torch.cli import main

raise SystemExit(main())
