from flink_tpu_torch.cli.frontend import main

raise SystemExit(main())
