from vxtpu_torch.app.run import main

raise SystemExit(main())
