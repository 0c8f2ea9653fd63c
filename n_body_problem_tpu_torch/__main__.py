from n_body_problem_tpu_torch.cli import main

raise SystemExit(main())
